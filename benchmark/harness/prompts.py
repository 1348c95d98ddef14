"""Text prompts drawn from the seed: "a <adjective> <subject> <place>",
short ASCII captions of the kind CLIP-GLaSS's users type. Every prompt
tokenizes to well under CLIP's 77-token context, and the text tower runs at
the full context whatever the prompt, so the seed changes the words and
never the work."""

from __future__ import annotations

import random
from typing import List

ADJECTIVES = ("red", "blue", "old", "young", "smiling", "tired", "golden", "wooden",
              "tiny", "giant", "bright", "dark", "wet", "frozen", "painted", "quiet")
SUBJECTS = ("man with brown eyes", "woman with curly hair", "child", "dog", "cat",
            "flower", "car", "house", "bird", "horse", "boat", "tree", "robot",
            "mountain", "bridge", "lighthouse")
PLACES = ("in the rain", "at night", "on a beach", "in a forest", "in the city",
          "under the sea", "in the snow", "at sunset", "in a studio", "on the moon",
          "in a garden", "by a lake")


def draw(rng: random.Random, n: int) -> List[str]:
    """n distinct prompts from `rng`."""
    out: List[str] = []
    while len(out) < n:
        p = f"a {rng.choice(ADJECTIVES)} {rng.choice(SUBJECTS)} {rng.choice(PLACES)}"
        if p not in out:
            out.append(p)
    return out
