"""Deterministic synthetic chat corpus for the in-repo tiny model.

A copy of ``fasttalk_tpu/training/corpus.py`` (pure Python): the port keeps
its own so AWQ's ``"corpus"`` calibration source
(``quantization/awq.py::calibration_tokens``) draws the same conversations
the tinychat checkpoint was trained on without importing the JAX package.

The hosting image has no network egress, so real checkpoints cannot be
downloaded (the reference always mounted real weights into its engine
containers — docker-compose.vllm.yml:58-59, docker-compose.gpu.yml:
30-34). Instead of serving random-weight noise, the framework trains a
small chat model on THIS corpus with its own training stack
(parallel/train.py) and serves the result — legible text, natural EOS
stops, and genuinely context-dependent behaviour.

Design: templated English conversations over small entity pools. The
load-bearing skill is *recall* — a user states a fact (name, favourite
color, pet) and asks for it back later in the conversation, sometimes
with distractor turns between. With ~100 equally likely names the
answer is not memorisable: the model must copy it from the context
(attention induction), which is what makes the multi-turn serving
transcript a real demonstration of context use rather than replay.

Everything is seeded and pure-Python deterministic, so tests and the
training script regenerate byte-identical data.
"""

from __future__ import annotations

import random
from typing import Iterator

Message = dict[str, str]

# The serving default (utils/config.py SYSTEM_PROMPT) appears verbatim
# so `python main.py websocket` with stock config stays in-distribution.
SYSTEM_DEFAULT = ("You are a helpful voice assistant. Keep responses "
                  "concise and conversational.")
SYSTEM_VARIANTS = [
    SYSTEM_DEFAULT,
    "You are FastTalk, a concise assistant.",
    "You are a friendly assistant.",
    "Answer briefly and politely.",
]

# Jinja template shipped in the checkpoint's tokenizer_config.json; the
# python render() below must stay its exact mirror — training text and
# serving prompts must tokenize identically.
CHAT_TEMPLATE_JINJA = (
    "<|bos|>{% for m in messages %}"
    "{% if m['role'] == 'system' %}<|sys|>{{ m['content'] }}<|eot|>"
    "{% elif m['role'] == 'user' %}<|user|>{{ m['content'] }}<|eot|>"
    "{% else %}<|asst|>{{ m['content'] }}<|eot|>{% endif %}"
    "{% endfor %}{% if add_generation_prompt %}<|asst|>{% endif %}")

SPECIALS = ["<unk>", "<|bos|>", "<|eot|>", "<|sys|>", "<|user|>",
            "<|asst|>", "<|pad|>"]

NAMES = [
    "Alice", "Bob", "Carol", "David", "Emma", "Frank", "Grace", "Henry",
    "Iris", "Jack", "Karen", "Leo", "Mia", "Noah", "Olivia", "Peter",
    "Quinn", "Rosa", "Sam", "Tina", "Uma", "Victor", "Wendy", "Xavier",
    "Yara", "Zoe", "Adam", "Bella", "Chris", "Diana", "Eric", "Fiona",
    "George", "Hannah", "Ivan", "Julia", "Kevin", "Laura", "Martin",
    "Nina", "Oscar", "Paula", "Ralph", "Sofia", "Tom", "Ursula", "Vera",
    "Walter", "Ximena", "Yuri", "Anna", "Bruno", "Clara", "Dennis",
    "Elena", "Felix", "Gina", "Hugo", "Ines", "Jonas", "Kira", "Lars",
    "Marta", "Nils", "Olga", "Pablo", "Rita", "Simon", "Tara", "Ulf",
    "Vince", "Willa", "Yan", "Zara", "Amos", "Beth", "Cole", "Dora",
    "Eli", "Faye", "Gus", "Hope", "Ida", "Joel", "Kate", "Liam", "Maya",
    "Ned", "Opal", "Pia", "Rex", "Sara", "Ted", "Una", "Val", "Wes",
]
COLORS = ["red", "blue", "green", "yellow", "purple", "orange", "pink",
          "brown", "black", "white", "gray", "gold", "silver", "teal"]
ANIMALS = ["cat", "dog", "bird", "fish", "horse", "rabbit", "fox",
           "owl", "bear", "wolf", "turtle", "hamster", "pony", "duck"]
NUMBER_WORDS = ["zero", "one", "two", "three", "four", "five", "six",
                "seven", "eight", "nine", "ten"]
COLOR_FACTS = [
    ("the sky", "blue"), ("grass", "green"), ("snow", "white"),
    ("the sun", "yellow"), ("blood", "red"), ("coal", "black"),
    ("milk", "white"), ("the sea", "blue"), ("a banana", "yellow"),
    ("a tomato", "red"), ("chocolate", "brown"), ("a cloud", "white"),
    ("an orange", "orange"), ("a leaf", "green"),
]
OPPOSITES = [
    ("hot", "cold"), ("big", "small"), ("fast", "slow"), ("up", "down"),
    ("day", "night"), ("light", "dark"), ("happy", "sad"),
    ("old", "new"), ("open", "closed"), ("loud", "quiet"),
    ("early", "late"), ("hard", "soft"), ("wet", "dry"),
    ("full", "empty"),
]
SOUNDS = [("cat", "meow"), ("dog", "woof"), ("duck", "quack"),
          ("cow", "moo"), ("sheep", "baa"), ("owl", "hoot")]

GREETINGS = ["hello", "hi", "hey there", "good morning", "good evening",
             "hi there"]


def _cap(s: str) -> str:
    return s[0].upper() + s[1:]


def render(messages: list[Message], add_generation_prompt: bool = False,
           ) -> str:
    """Python mirror of CHAT_TEMPLATE_JINJA (must stay identical)."""
    tags = {"system": "<|sys|>", "user": "<|user|>",
            "assistant": "<|asst|>"}
    out = ["<|bos|>"]
    for m in messages:
        out.append(f"{tags[m['role']]}{m['content']}<|eot|>")
    if add_generation_prompt:
        out.append("<|asst|>")
    return "".join(out)


def _turn_pairs(rng: random.Random, memory: dict) -> list[tuple[str, str]]:
    """One user/assistant exchange; may record or use ``memory``."""
    kind = rng.choice(
        ["greet", "whoami", "name_intro", "color_intro", "pet_intro",
         "fact", "math_plus", "math_minus", "count", "opposite",
         "sound", "thanks", "bye", "name_recall", "color_recall",
         "pet_recall"])
    if kind == "name_recall" and "name" not in memory:
        kind = "name_intro"
    if kind == "color_recall" and "color" not in memory:
        kind = "color_intro"
    if kind == "pet_recall" and "pet" not in memory:
        kind = "pet_intro"

    if kind == "greet":
        return [(rng.choice(GREETINGS),
                 "Hello! How can I help you today?")]
    if kind == "whoami":
        return [(rng.choice(["who are you?", "what are you?"]),
                 "I am FastTalk, a tiny assistant that lives in this "
                 "repository.")]
    if kind == "name_intro":
        name = rng.choice(NAMES)
        memory["name"] = name
        return [(f"my name is {name}.", f"Nice to meet you, {name}!")]
    if kind == "name_recall":
        return [("what is my name?",
                 f"Your name is {memory['name']}.")]
    if kind == "color_intro":
        color = rng.choice(COLORS)
        memory["color"] = color
        return [(f"my favorite color is {color}.",
                 f"{_cap(color)} is a lovely color!")]
    if kind == "color_recall":
        return [("what is my favorite color?",
                 f"Your favorite color is {memory['color']}.")]
    if kind == "pet_intro":
        pet = rng.choice(ANIMALS)
        memory["pet"] = pet
        return [(f"i have a pet {pet}.",
                 f"A {pet} is a wonderful pet!")]
    if kind == "pet_recall":
        return [("what pet do i have?",
                 f"You have a {memory['pet']}.")]
    if kind == "fact":
        thing, color = rng.choice(COLOR_FACTS)
        return [(f"what color is {thing}?",
                 f"{_cap(thing)} is {color}.")]
    if kind == "math_plus":
        a = rng.randint(0, 10)
        b = rng.randint(0, 10 - a)
        return [(f"what is {NUMBER_WORDS[a]} plus {NUMBER_WORDS[b]}?",
                 f"{_cap(NUMBER_WORDS[a])} plus {NUMBER_WORDS[b]} is "
                 f"{NUMBER_WORDS[a + b]}.")]
    if kind == "math_minus":
        a = rng.randint(0, 10)
        b = rng.randint(0, a)
        return [(f"what is {NUMBER_WORDS[a]} minus {NUMBER_WORDS[b]}?",
                 f"{_cap(NUMBER_WORDS[a])} minus {NUMBER_WORDS[b]} is "
                 f"{NUMBER_WORDS[a - b]}.")]
    if kind == "count":
        n = rng.randint(3, 10)
        seq = ", ".join(NUMBER_WORDS[1:n + 1])
        return [(f"count from one to {NUMBER_WORDS[n]}.",
                 f"{_cap(seq)}.")]
    if kind == "opposite":
        w, o = rng.choice(OPPOSITES)
        return [(f"what is the opposite of {w}?",
                 f"The opposite of {w} is {o}.")]
    if kind == "sound":
        a, s = rng.choice(SOUNDS)
        return [(f"what sound does a {a} make?",
                 f"A {a} says {s}.")]
    if kind == "thanks":
        return [(rng.choice(["thank you", "thanks a lot", "thanks"]),
                 "You're welcome!")]
    return [(rng.choice(["goodbye", "bye", "see you later"]),
             "Goodbye! Have a great day!")]


def conversation(rng: random.Random) -> list[Message]:
    msgs: list[Message] = []
    r = rng.random()
    if r < 0.5:
        msgs.append({"role": "system", "content": SYSTEM_DEFAULT})
    elif r < 0.8:
        msgs.append({"role": "system",
                     "content": rng.choice(SYSTEM_VARIANTS)})
    memory: dict = {}
    n_turns = rng.randint(1, 5)
    planned_recall = rng.random() < 0.6  # recall-rich: the core skill
    for t in range(n_turns):
        if planned_recall and t == n_turns - 1 and memory:
            # force a recall exchange for a remembered fact
            key = rng.choice(sorted(memory))
            if key == "name":
                pair = [("what is my name?",
                         f"Your name is {memory['name']}.")]
            elif key == "color":
                pair = [("what is my favorite color?",
                         f"Your favorite color is {memory['color']}.")]
            else:
                pair = [("what pet do i have?",
                         f"You have a {memory['pet']}.")]
        else:
            pair = _turn_pairs(rng, memory)
        for u, a in pair:
            msgs.append({"role": "user", "content": u})
            msgs.append({"role": "assistant", "content": a})
    return msgs


def conversations(n: int, seed: int = 0) -> Iterator[list[Message]]:
    rng = random.Random(seed)
    for _ in range(n):
        yield conversation(rng)


def corpus_texts(n: int, seed: int = 0) -> Iterator[str]:
    """Rendered training documents (one conversation per string)."""
    for msgs in conversations(n, seed):
        yield render(msgs)
