"""Training: the synthetic chat corpus, the training loop's pieces, the
optimizer and schedule, and the HF export.

Counterpart of ``fasttalk_tpu/training/``. The training stack
(parallel/train.py) trains the model the engine serves; ``python -m
fasttalk_tpu_torch train`` (training/tinychat.py) trains and exports the
tinychat model with it. The corpus also feeds AWQ calibration.
"""

from fasttalk_tpu_torch.training.corpus import (CHAT_TEMPLATE_JINJA,
                                                SPECIALS, conversations,
                                                corpus_texts, render)
from fasttalk_tpu_torch.training.export import export_checkpoint
from fasttalk_tpu_torch.training.optim import (adamw,
                                               warmup_cosine_decay_schedule)
from fasttalk_tpu_torch.training.trainer import (greedy_generate,
                                                 make_eval_loss,
                                                 make_sampled_train_step,
                                                 pack_tokens,
                                                 single_device_mesh,
                                                 train_tokenizer)

__all__ = [
    "CHAT_TEMPLATE_JINJA", "SPECIALS", "conversations", "corpus_texts",
    "render", "export_checkpoint", "greedy_generate", "make_eval_loss",
    "make_sampled_train_step", "pack_tokens", "single_device_mesh",
    "train_tokenizer", "adamw", "warmup_cosine_decay_schedule",
]
