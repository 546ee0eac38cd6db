"""The port's training stack held against the JAX package's on the CPU.

In process, float32, on a tiny Llama (2 layers, hidden 64, 8 query over 4
KV heads; tied, untied, and untied with ``qkv_bias``), the same seeded
inputs through ``fasttalk_tpu/parallel/train.py`` and
``fasttalk_tpu_torch/parallel/train.py`` (weights moved with
``models/loader.py::from_jax_params``):

- ``causal_lm_loss`` with and without ``loss_mask``: within 1e-5 relative;
- every gradient leaf against ``jax.grad``: within 1e-4 of the leaf's
  largest magnitude;
- three ``make_train_step`` steps against JAX's on ``single_device_mesh()``
  (tied, and untied with biases): losses within 1e-5 relative, every param
  within 1e-5 absolute, the Adam moments (the steps' own gradients) within
  1e-4 of each leaf's largest magnitude, and each param's move within 1e-2
  of the rate a step where the gradient is well above ``eps``;
- the port's AdamW against ``optax.adamw`` on the same gradients, with a
  constant rate and with the warm-up cosine schedule, and the schedule
  against optax's at every step (1e-7);
- ``eval_step``/``make_eval_loss``, ``pack_tokens``, and the sampled step:
  rows uniform over many draws, each step equal to ``make_train_step`` on
  the rows it drew.

The three-step comparison runs at a learning rate of 1e-5. Adam divides
each gradient element by its own magnitude, so an element whose gradient
is of the order of ``eps`` (1e-8) turns the two packages' 1e-6-relative
gradient difference into an update difference of up to twice the rate:
at 1e-3 two w_up elements of 16,384 (gradient 1.0e-8) parted by 2.1e-4.
The params bound is therefore about the size of the update itself, and
the update is held apart: on the elements whose gradient (the root of
Adam's bias-corrected second moment) is above 1e3 ``eps``, where an
update is ``lr g / (|g| + eps)`` to within 1e-3 of the rate, the move of
each param from its start is held to JAX's within 1e-2 of the rate over
the steps (plus the float32 spacing of the param it lands on), so a step
that skips its update or turns its sign fails by the rate itself. The
optimizer alone is held to optax at 1e-3 on identical gradients.

Across processes: one 4-rank gloo world (tests/_torch_ranks.py ``train``)
runs the train step at dp = 2 x tp = 2 (tied head), tp = 4 (untied
head), sp = 2 in the gathered and the forced ring form, and dp = 2 x
sp = 2. Each rank's loss, synced gradients, Adam moments after the step,
updated params and their moves are held to JAX's ``make_train_step`` on
the same mesh shape (the 8 host devices of tests/conftest.py) with the
bounds above; the replicated leaves' gradients, moments and params are
bit-equal on every rank that holds them; the ring form
equals the gathered one; a tp = 2 forward with grad on gives the bits of
the serving forward under ``no_grad``.

Tinychat and the export: ``greedy_generate`` on the committed checkpoint
equals JAX's token for token; both ``export_checkpoint``s write the same
files from the same params; the port's export loads through
``load_params`` and serves through ``build_engine`` the reply
``greedy_generate`` gives; ``python -m fasttalk_tpu_torch train`` writes a
checkpoint the loader reads.
"""

import dataclasses
import functools
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fasttalk_tpu.models import llama as jllama
from fasttalk_tpu.models.configs import ModelConfig as JaxConfig
from fasttalk_tpu.parallel import mesh as jmesh
from fasttalk_tpu.parallel import train as jtrain
from fasttalk_tpu.training import trainer as jtrainer
from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.loader import from_jax_params
from fasttalk_tpu_torch.parallel import mesh as tmesh
from fasttalk_tpu_torch.parallel import sharding as tsharding
from fasttalk_tpu_torch.parallel import train as ttrain
from fasttalk_tpu_torch.training import optim as toptim
from fasttalk_tpu_torch.training import trainer as ttrainer
from tests._port_isolation import port_isolation  # noqa: F401
from tests._torch_ranks import (ASSETS, TRAIN_CASES, TRAIN_LR, TRAIN_STEPS,
                                spawn)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4      # of the leaf's largest magnitude
PARAM_ATOL = 1e-5
SCHEDULE_ATOL = 1e-7
STEP_LR = 1e-5       # the three-step comparison (module notes)
UPDATE_TOL = 1e-2    # of the rate a step: the params' moves (module notes)
HELD_GRAD = 1e-5     # 1e3 eps: the gradients whose moves are held

TINY = dict(name="train-tiny", vocab_size=256, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=8,
            num_kv_heads=4, head_dim=8, rope_theta=10000.0)
KINDS = {"tied": dict(tie_embeddings=True),
         "untied": dict(tie_embeddings=False),
         "bias": dict(tie_embeddings=False, qkv_bias=True)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(kind):
    kw = {**TINY, **KINDS[kind]}
    return JaxConfig(**kw), ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _host_params(kind):
    """The JAX init as numpy leaves (biases drawn, as the init zeroes
    them)."""
    jc, _ = _configs(kind)
    init = jax.jit(jllama.init_params, static_argnums=(0, 2))
    host = jax.tree.map(np.asarray,
                        init(jc, jax.random.PRNGKey(0), jnp.float32))
    if jc.qkv_bias:
        rs = np.random.RandomState(1)
        for name in ("bq", "bk", "bv"):
            shape = host["layers"][name].shape
            host["layers"][name] = (rs.randn(*shape) * 0.1).astype(
                np.float32)
    return host


# JAX's gradient, jitted (``cfg`` static): the JAX package's own function,
# one compile instead of an eager dispatch of every op of the backward.
_jax_grad = jax.jit(jax.grad(jtrain.causal_lm_loss), static_argnums=1)


def _jax_params(kind):
    return jax.tree.map(jnp.asarray, _host_params(kind))


def _torch_params(kind):
    return from_jax_params(_host_params(kind), "cpu")


def _tokens(b=4, t=17, seed=0):
    return np.random.RandomState(seed).randint(
        0, TINY["vocab_size"], (b, t)).astype(np.int32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_params_close(got, want, atol=PARAM_ATOL):
    want = dict(_leaves(want))
    got = dict(_leaves(got))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(np.asarray(got[key].detach()),
                                   np.asarray(w), atol=atol, rtol=0,
                                   err_msg=str(key))


def _moments(state):
    """The Adam moments of an optax state, as numpy trees."""
    return tuple(jax.tree.map(np.asarray, optax.tree_utils.tree_get(state, k))
                 for k in ("mu", "nu"))


def _numpy(tree):
    """A dict of torch tensors as numpy arrays, keyed alike."""
    return {k: v.detach().numpy() for k, v in tree.items()}


def _assert_update_close(before, got, want, want_nu, steps, lr, what=""):
    """Each param's move from ``before`` against JAX's, within
    ``UPDATE_TOL`` of the rate a step (and the float32 spacing of the
    param it lands on), on the elements whose bias-corrected gradient
    root, from JAX's second moment ``want_nu``, is above ``HELD_GRAD``;
    all four are dicts of numpy arrays keyed alike. At least half the
    elements of the model are held."""
    held = total = 0
    for key, w in want.items():
        nu_hat = want_nu[key] / (1 - np.float32(0.999) ** steps)
        mask = np.sqrt(nu_hat) > HELD_GRAD
        moved = got[key] - before[key]
        want_moved = w - before[key]
        tol = UPDATE_TOL * lr * steps + np.spacing(np.abs(w))
        bad = mask & (np.abs(moved - want_moved) > tol)
        assert not bad.any(), (
            f"{what} {key}: {int(bad.sum())} of {int(mask.sum())} held "
            f"elements moved {moved[bad][:4]} against {want_moved[bad][:4]}")
        held += int(mask.sum())
        total += mask.size
    assert held >= total // 2, (held, total)


def _assert_grads_close(got, want):
    """Every leaf within ``GRAD_TOL`` of the JAX leaf's largest
    magnitude; ``got`` keyed by leaf path."""
    for key, w in _leaves(want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(got[key]), w,
                                   atol=GRAD_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=str(key))


# ------------------------------------------------------------ in process


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_causal_lm_loss_matches_jax(kind, masked):
    jc, tc = _configs(kind)
    toks = _tokens()
    mask = (np.random.RandomState(2).rand(4, 16) > 0.3).astype(np.float32) \
        if masked else None
    want = float(jtrain.causal_lm_loss(
        _jax_params(kind), jc, jnp.asarray(toks),
        None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = float(ttrain.causal_lm_loss(
            _torch_params(kind), tc, torch.as_tensor(toks).long(),
            None if mask is None else torch.as_tensor(mask)))
    assert abs(got - want) <= LOSS_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gradients_match_jax_grad(kind):
    jc, tc = _configs(kind)
    toks = _tokens()
    mask = (np.random.RandomState(3).rand(4, 16) > 0.5).astype(np.float32)
    want = _jax_grad(_jax_params(kind), jc, jnp.asarray(toks),
                     jnp.asarray(mask))
    value, got = ttrain.value_and_grad(
        lambda p: ttrain.causal_lm_loss(p, tc, torch.as_tensor(toks).long(),
                                        torch.as_tensor(mask)),
        _torch_params(kind))
    assert value.shape == () and not value.requires_grad
    assert set(got) == {k for k, _ in _leaves(want)}
    _assert_grads_close(got, want)


@pytest.mark.parametrize("kind", ["tied", "bias"])
def test_three_train_steps_match_jax(kind):
    jc, tc = _configs(kind)
    toks = _tokens()
    jm = jtrainer.single_device_mesh()
    jp, jstate, jopt = jtrain.init_sharded_training(jc, _jax_params(kind),
                                                    jm, STEP_LR)
    jstep = jtrain.make_train_step(jc, jopt, jm)
    mesh = ttrainer.single_device_mesh()
    source = _torch_params(kind)
    before = {k: v.clone() for k, v in _leaves(source)}
    tp, tstate, topt = ttrain.init_sharded_training(tc, source, mesh,
                                                    STEP_LR)
    tstep = ttrain.make_train_step(tc, topt, mesh)
    for _ in range(3):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(toks))
        tp, tstate, tloss = tstep(tp, tstate, toks)
        assert abs(float(tloss) - float(jloss)) \
            <= LOSS_RTOL * abs(float(jloss))
    _assert_params_close(tp, jp)
    assert tstate["count"] == 3
    mu, nu = _moments(jstate)
    for name, want in (("mu", mu), ("nu", nu)):
        _assert_grads_close(_numpy(dict(_leaves(tstate[name]))), want)
    _assert_update_close(_numpy(before), _numpy(dict(_leaves(tp))),
                         dict(_leaves(jax.tree.map(np.asarray, jp))),
                         dict(_leaves(nu)), 3, STEP_LR)
    # The caller's params are left as they were (JAX copies them onto the
    # mesh and donates the copy).
    for k, v in _leaves(source):
        assert torch.equal(v, before[k]), k


def test_train_step_refuses_quantized_params():
    from fasttalk_tpu_torch.ops.quant import quantize_params

    _, tc = _configs("tied")
    with pytest.raises(ValueError, match="training needs float params"):
        ttrain.init_sharded_training(
            tc, quantize_params(_torch_params("tied")),
            ttrainer.single_device_mesh())


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_optax_on_the_same_gradients(schedule):
    """Five updates of the same params with the same gradients: the port's
    AdamW against ``optax.adamw``, weight decay 0.01 (the tinychat
    recipe), a constant rate or the warm-up cosine schedule."""
    rs = np.random.RandomState(5)
    params = {"a": rs.randn(64, 32).astype(np.float32),
              "layers": {"b": rs.randn(3, 16).astype(np.float32)}}
    if schedule:
        lr_j = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 5, 1e-4)
        lr_t = toptim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 5, 1e-4)
    else:
        lr_j = lr_t = 1e-3
    jopt = optax.adamw(lr_j, weight_decay=0.01)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = toptim.adamw(lr_t, weight_decay=0.01)
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "layers": {"b": torch.from_numpy(params["layers"]["b"].copy())}}
    tstate = topt.init(tp)
    for _ in range(5):
        grads = {"a": rs.randn(64, 32).astype(np.float32) * 1e-2,
                 "layers": {"b": rs.randn(3, 16).astype(np.float32)}}
        grads["a"][0, :4] = 0.0   # untouched rows: decay only
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads),
                                      jstate, jp)
        jp = optax.apply_updates(jp, updates)
        topt.update({k: torch.from_numpy(v) for k, v in _leaves(grads)},
                    tstate, tp)
    _assert_params_close(tp, jp, atol=1e-7)
    assert tstate["mu"]["a"].dtype == torch.float32


def test_warmup_cosine_schedule_matches_optax():
    """The tinychat recipe's schedule (and a short one) at every step,
    past the end too."""
    for args in ((0.0, 1e-3, 200, 6000, 1e-4), (0.0, 1e-3, 1, 3, 1e-4),
                 (5e-4, 1e-3, 0, 10, 0.0)):
        want = optax.warmup_cosine_decay_schedule(*args)
        got = toptim.warmup_cosine_decay_schedule(*args)
        steps = np.unique(np.r_[0:min(args[3], 300) + 20,
                                args[3] - 20:args[3] + 20,
                                0:args[3]:97])
        np.testing.assert_allclose([got(int(s)) for s in steps],
                                   np.asarray(want(steps)),
                                   atol=SCHEDULE_ATOL, rtol=0)
    with pytest.raises(ValueError) as want:
        optax.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)
    with pytest.raises(ValueError) as got:
        toptim.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)
    assert str(got.value) == str(want.value)


def test_eval_step_and_make_eval_loss_match_jax():
    jc, tc = _configs("untied")
    toks = _tokens(seed=4)
    want = float(jtrain.eval_step(jc, jtrainer.single_device_mesh())(
        _jax_params("untied"), jnp.asarray(toks)))
    tp = _torch_params("untied")
    a = float(ttrain.eval_step(tc, ttrainer.single_device_mesh())(tp, toks))
    b = float(ttrainer.make_eval_loss(tc)(tp, toks))
    assert float(jtrainer.make_eval_loss(jc)(
        _jax_params("untied"), jnp.asarray(toks))) == pytest.approx(
            want, rel=1e-7)
    assert a == b
    assert abs(a - want) <= LOSS_RTOL * abs(want)


def test_pack_tokens_matches_jax():
    stream = list(np.random.RandomState(6).randint(0, 999, 1000))
    for seq in (7, 64, 999, 1000):
        got = ttrainer.pack_tokens(stream, seq)
        want = jtrainer.pack_tokens(stream, seq)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_sampled_rows_are_uniform_over_many_draws():
    """Rows drawn with replacement, uniformly: over 2,000 steps of 64 rows
    from 32, every row's count is within 5 standard deviations of its
    mean; the draw of a step is the same every time."""
    n, batch, steps = 32, 64, 2000
    counts = np.zeros(n)
    for step in range(steps):
        idx = ttrainer.sample_rows(n, batch, step, "cpu")
        assert idx.shape == (batch,) and idx.dtype == torch.int64
        counts += np.bincount(idx.numpy(), minlength=n)
    mean = steps * batch / n
    sd = np.sqrt(steps * batch * (1 / n) * (1 - 1 / n))
    assert np.abs(counts - mean).max() < 5 * sd, counts
    chi2 = ((counts - mean) ** 2 / mean).sum()
    assert chi2 < 2 * (n - 1) + 10 * np.sqrt(2 * (n - 1)), chi2
    assert torch.equal(ttrainer.sample_rows(n, batch, 7, "cpu"),
                       ttrainer.sample_rows(n, batch, 7, "cpu"))
    assert not torch.equal(ttrainer.sample_rows(n, batch, 7, "cpu"),
                           ttrainer.sample_rows(n, batch, 8, "cpu"))


def test_sampled_step_equals_train_step_on_its_rows():
    _, tc = _configs("tied")
    data = torch.as_tensor(_tokens(b=24, t=13, seed=8)).long()
    mesh = ttrainer.single_device_mesh()
    pa, sa, oa = ttrain.init_sharded_training(tc, _torch_params("tied"),
                                              mesh, 1e-3)
    pb, sb, ob = ttrain.init_sharded_training(tc, _torch_params("tied"),
                                              mesh, 1e-3)
    sampled = ttrainer.make_sampled_train_step(tc, oa, mesh, batch=4)
    plain = ttrain.make_train_step(tc, ob, mesh)
    for step in (0, 1, 5):
        pa, sa, la = sampled(pa, sa, data, step)
        rows = data[ttrainer.sample_rows(data.shape[0], 4, step, "cpu")]
        pb, sb, lb = plain(pb, sb, rows)
        assert torch.equal(la, lb)
    for key, t in _leaves(pa):
        assert torch.equal(t, dict(_leaves(pb))[key]), key


# ------------------------------------------------------- the 4-rank world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One 4-rank gloo world that runs every case of ``TRAIN_CASES``; its
    inputs and each rank's outputs."""
    out = str(tmp_path_factory.mktemp("train_ranks"))
    inp = {"tokens": _tokens(seed=9)}
    for kind in ("tied", "untied"):
        inp.update({f"{kind}/{'/'.join(k)}": v
                    for k, v in _leaves(_host_params(kind))})
    np.savez(os.path.join(out, "inputs.npz"), **inp)
    with open(os.path.join(out, "configs.json"), "w",
              encoding="utf-8") as f:
        json.dump({k: dataclasses.asdict(_configs(k)[1])
                   for k in ("tied", "untied")}, f)
    # The ranks run while this process computes JAX's references (the
    # spawning thread only waits on them).
    failed = []

    def run():
        try:
            spawn("train", 4, out, timeout=150)
        except BaseException as e:   # re-raised in the test process
            failed.append(e)

    ranks = threading.Thread(target=run)
    ranks.start()
    try:
        for case in TRAIN_CASES:
            _jax_case(case[0])
    finally:
        ranks.join()
    if failed:
        raise failed[0]
    return inp, [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                 for r in range(4)]


def _local(tree, spec, rank):
    """The torch dict of a JAX tree's leaves cut to ``rank``'s shards."""
    full = from_jax_params(jax.tree.map(np.asarray, tree), "cpu")
    return dict(_leaves(tsharding.shard_params(full,
                                               tmesh.Mesh(spec, rank))))


@functools.lru_cache(maxsize=None)
def _jax_grads(kind):
    """``jax.grad`` of the world's batch loss (one device: the gradient
    does not depend on the layout)."""
    jc, _ = _configs(kind)
    return _jax_grad(_jax_params(kind), jc, jnp.asarray(_tokens(seed=9)))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's ``make_train_step`` on the case's mesh shape: the step losses
    (the first is the loss before any update), and the params and the Adam
    moments after ``TRAIN_STEPS`` steps."""
    _, (dp, sp, tp), kind, ring = next(c for c in TRAIN_CASES
                                       if c[0] == name)
    jc, _ = _configs(kind)
    toks = jnp.asarray(_tokens(seed=9))
    m = jmesh.make_mesh(dp=dp, sp=sp, tp=tp)
    params, state, opt = jtrain.init_sharded_training(
        jc, _jax_params(kind), m, TRAIN_LR)
    step = jtrain.make_train_step(jc, opt, m,
                                  ring_min_seq=0 if ring else 4096)
    losses = []
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    return (_jax_grads(kind), losses, jax.tree.map(np.asarray, params),
            *_moments(state))


def _rank_tree(rank_out, name, what):
    prefix = f"{name}/{what}/"
    return {tuple(k[len(prefix):].split("/")): torch.from_numpy(v)
            for k, v in rank_out.items() if k.startswith(prefix)}


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_sharded_train_step_matches_jax_mesh_step(world, name):
    _, ranks = world
    _, (dp, sp, tp), kind, _ = next(c for c in TRAIN_CASES if c[0] == name)
    spec = tmesh.MeshSpec(dp=dp, sp=sp, tp=tp)
    grads, losses, params, mu, nu = _jax_case(name)
    for rank in range(spec.size):
        got = ranks[rank]
        np.testing.assert_allclose(got[f"{name}/loss"], losses,
                                   rtol=LOSS_RTOL, atol=0)
        # eval_step before the steps: JAX's loss of the first step.
        np.testing.assert_allclose(got[f"{name}/eval"], losses[0],
                                   rtol=LOSS_RTOL, atol=0)
        want_g = _local(grads, spec, rank)
        got_g = _rank_tree(got, name, "grad")
        assert got_g.keys() == want_g.keys()
        full = dict(_leaves(grads))
        for key, w in want_g.items():
            np.testing.assert_allclose(
                got_g[key].numpy(), w.numpy(),
                atol=GRAD_TOL * np.abs(np.asarray(full[key])).max(), rtol=0,
                err_msg=f"rank {rank} {key}")
        want_p = _local(params, spec, rank)
        got_p = _rank_tree(got, name, "param")
        assert got_p.keys() == want_p.keys()
        for key, w in want_p.items():
            np.testing.assert_allclose(got_p[key].numpy(), w.numpy(),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"rank {rank} {key}")
        # The step's own gradients, through its moments (mu = 0.1 g and
        # nu = 1e-3 g^2 after one step), and the update it applied.
        for what, tree in (("mu", mu), ("nu", nu)):
            want_m = _local(tree, spec, rank)
            got_m = _rank_tree(got, name, what)
            assert got_m.keys() == want_m.keys()
            full_m = dict(_leaves(tree))
            for key, w in want_m.items():
                np.testing.assert_allclose(
                    got_m[key].numpy(), w.numpy(),
                    atol=GRAD_TOL * np.abs(full_m[key]).max(), rtol=0,
                    err_msg=f"rank {rank} {what} {key}")
        _assert_update_close(
            _numpy(_local(_host_params(kind), spec, rank)), _numpy(got_p),
            _numpy(want_p), _numpy(_local(nu, spec, rank)), TRAIN_STEPS,
            TRAIN_LR, f"rank {rank}")


@pytest.mark.parametrize("name", [c[0] for c in TRAIN_CASES])
def test_replicated_gradients_are_bit_equal_across_ranks(world, name):
    """Every rank that holds the same shard of a leaf (all of them for a
    replicated leaf; the ranks of one "tp" coordinate for a "tp"-sharded
    one) ends the backward with the same bits, and so with the same
    moments and params after the steps."""
    _, ranks = world
    _, (dp, sp, tp), _, _ = next(c for c in TRAIN_CASES if c[0] == name)
    spec = tmesh.MeshSpec(dp=dp, sp=sp, tp=tp)
    for what in ("grad", "mu", "nu", "param"):
        trees = [_rank_tree(ranks[r], name, what)
                 for r in range(spec.size)]
        for key, t in trees[0].items():
            leaf_spec = tsharding._spec_for(key[-1], t.dim(), tuple(t.shape))
            sharded = "tp" in leaf_spec and tp > 1
            for rank in range(spec.size):
                peer = rank % tp if sharded else 0
                assert torch.equal(trees[rank][key], trees[peer][key]), \
                    (what, key, rank)


def test_forced_ring_equals_the_gathered_form(world):
    _, ranks = world
    for rank in range(2):
        got, want = ranks[rank], ranks[rank]
        np.testing.assert_allclose(got["sp2_ring/loss"], want["sp2/loss"],
                                   rtol=1e-5, atol=0)
        for what in ("grad", "mu", "nu", "param"):
            ring = _rank_tree(got, "sp2_ring", what)
            gathered = _rank_tree(want, "sp2", what)
            assert ring.keys() == gathered.keys()
            for key, t in gathered.items():
                scale = 1.0 if what == "param" else float(t.abs().max())
                np.testing.assert_allclose(ring[key].numpy(), t.numpy(),
                                           atol=1e-5 * scale, rtol=0,
                                           err_msg=f"{what} {key}")
        _assert_update_close(
            _numpy(_local(_host_params("tied"), tmesh.MeshSpec(sp=2), rank)),
            _numpy(_rank_tree(got, "sp2_ring", "param")),
            _numpy(_rank_tree(want, "sp2", "param")),
            _numpy(_rank_tree(want, "sp2", "nu")), TRAIN_STEPS, TRAIN_LR,
            f"rank {rank}")


def test_serving_forward_keeps_its_bits_with_grad_on(world):
    """The tp = 2 forward with grad on (the collectives' autograd path)
    gives the bits of the same forward under ``no_grad`` (serving's path),
    on both ranks, and both ranks the same."""
    _, ranks = world
    for rank in range(2):
        np.testing.assert_array_equal(ranks[rank]["tp2/grad"],
                                      ranks[rank]["tp2/nograd"])
        np.testing.assert_array_equal(ranks[rank]["tp2/nograd"],
                                      ranks[0]["tp2/nograd"])


# ------------------------------------------------ tinychat and the export

PROBES = [
    [{"role": "user", "content": "what color is the sky?"}],
    [{"role": "user", "content": "my name is Ada."},
     {"role": "assistant", "content": "Nice to meet you, Ada!"},
     {"role": "user", "content": "what is my name?"}],
]


@functools.lru_cache(maxsize=None)
def _tinychat():
    from tokenizers import Tokenizer

    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.loader import load_params as jax_load
    from fasttalk_tpu_torch.models.configs import get_model_config

    ckpt = os.path.join(ASSETS, "tinychat")
    jc = jax_cfg("tinychat", ASSETS)
    jp = jax_load(jc, ckpt, jnp.float32)
    tok = Tokenizer.from_file(os.path.join(ckpt, "tokenizer.json"))
    return jc, jp, get_model_config("tinychat", ASSETS), tok


def _prompt_ids(tok, msgs):
    from fasttalk_tpu_torch.training.corpus import render

    return tok.encode(render(msgs, add_generation_prompt=True),
                      add_special_tokens=False).ids


def test_greedy_generate_on_tinychat_matches_jax():
    jc, jp, tc, tok = _tinychat()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    eot = tok.token_to_id("<|eot|>")
    for msgs in PROBES:
        ids = _prompt_ids(tok, msgs)
        want = jtrainer.greedy_generate(jp, jc, ids, max_new=24, eos_id=eot)
        got = ttrainer.greedy_generate(tp, tc, ids, max_new=24, eos_id=eot)
        assert got == want
        assert got[-1] == eot   # a real reply, stopped by its EOS


def test_both_exports_write_the_same_checkpoint(tmp_path):
    from safetensors.numpy import load_file

    from fasttalk_tpu.training.export import export_checkpoint as jax_export
    from fasttalk_tpu_torch.training.corpus import CHAT_TEMPLATE_JINJA
    from fasttalk_tpu_torch.training.export import export_checkpoint

    tok_json = os.path.join(ASSETS, "tinychat", "tokenizer.json")
    for kind in ("tied", "bias"):
        jc, tc = _configs(kind)
        dirs = {}
        for label, fn, params, cfg in (
                ("jax", jax_export, _jax_params(kind), jc),
                ("torch", export_checkpoint, _torch_params(kind), tc)):
            dirs[label] = str(tmp_path / kind / label)
            fn(params, cfg, dirs[label], chat_template=CHAT_TEMPLATE_JINJA,
               eos_token="<|eot|>", bos_token="<|bos|>",
               tokenizer_json=tok_json)
        for name in ("config.json", "tokenizer.json",
                     "tokenizer_config.json"):
            with open(os.path.join(dirs["jax"], name), "rb") as a, \
                    open(os.path.join(dirs["torch"], name), "rb") as b:
                assert a.read() == b.read(), name
        want = load_file(os.path.join(dirs["jax"], "model.safetensors"))
        got = load_file(os.path.join(dirs["torch"], "model.safetensors"))
        assert got.keys() == want.keys()
        for name, w in want.items():
            assert got[name].dtype == w.dtype and got[name].shape == w.shape
            np.testing.assert_array_equal(got[name].view(np.uint16),
                                          w.view(np.uint16), err_msg=name)


def test_exported_tinychat_loads_and_serves_the_greedy_reply(tmp_path):
    """The committed tinychat through the port's export: ``load_params``
    reads back the bf16-rounded params, and ``build_engine`` serves each
    probe the reply ``greedy_generate`` gives on them."""
    import asyncio

    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params
    from fasttalk_tpu_torch.training.corpus import CHAT_TEMPLATE_JINJA
    from fasttalk_tpu_torch.training.export import export_checkpoint
    from fasttalk_tpu_torch.utils.config import Config

    _, jp, tc, tok = _tinychat()
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    out = tmp_path / "tinychat"
    export_checkpoint(tp, tc, str(out), chat_template=CHAT_TEMPLATE_JINJA,
                      eos_token="<|eot|>", bos_token="<|bos|>",
                      tokenizer_json=os.path.join(ASSETS, "tinychat",
                                                  "tokenizer.json"))
    cfg = get_model_config("tinychat", str(tmp_path))
    assert cfg == tc
    back = load_params(cfg, str(out), torch.float32, "cpu")
    for key, t in _leaves(tp):
        assert torch.equal(dict(_leaves(back))[key],
                           t.to(torch.bfloat16).to(torch.float32)), key
    eng = build_engine(Config(
        model_name="tinychat", model_path=str(tmp_path), weight_quant="off",
        dtype="float32", decode_slots=2, max_model_len=512,
        default_context_window=512, spec_decode="off", shared_prefix=False,
        decode_steps_per_call=8), device="cpu", prepared_cache=False)
    eot = tok.token_to_id("<|eot|>")

    async def reply(msgs):
        text, final = "", None
        async for ev in eng.generate("r", "s", msgs, GenerationParams(
                max_tokens=24, temperature=0.0, top_k=0, top_p=1.0)):
            if ev["type"] == "token":
                text += ev["text"]
            else:
                final = ev
        return text, final

    eng.start()
    try:
        for msgs in PROBES:
            gen = ttrainer.greedy_generate(back, cfg, _prompt_ids(tok, msgs),
                                           max_new=24, eos_id=eot)
            text, final = asyncio.run(reply(msgs))
            assert final["finish_reason"] == "stop"
            assert text == tok.decode(gen, skip_special_tokens=True)
            assert gen[-1] == eot
            assert final["stats"]["tokens_generated"] == len(gen) - 1
    finally:
        eng.shutdown()


def test_train_command_writes_a_checkpoint_the_loader_reads(tmp_path,
                                                           capsys):
    """``python -m fasttalk_tpu_torch train --device cpu --steps 3 --convs
    64 --force-export --out <tmp>``, through the command's ``main`` in this
    process."""
    from fasttalk_tpu_torch.__main__ import main
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import load_params
    from fasttalk_tpu_torch.training.tinychat import TINYCHAT

    out = tmp_path / "tinychat"
    assert main(["train", "--device", "cpu", "--steps", "3", "--convs",
                 "64", "--force-export", "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "step     0" in err and "step     2" in err
    assert "recall probe:" in err and f"exported {out}" in err
    cfg = get_model_config("tinychat", str(tmp_path))
    assert dataclasses.replace(cfg, chat_template=TINYCHAT.chat_template) \
        == TINYCHAT
    params = load_params(cfg, str(out), torch.float32, "cpu")
    assert params["layers"]["wq"].shape == (4, 256, 256)
    assert all(torch.isfinite(t).all() for _, t in _leaves(params))


def test_train_command_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    from fasttalk_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train", "--steps", "1"])
