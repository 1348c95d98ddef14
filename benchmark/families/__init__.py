"""What the harness does differently by model family, one module a family,
found by the configuration file's `family` key
(`benchmark/families/<family>.py`), so that a new family is a new file.

Each module gives:
- `make_weights(config, gen, log)`: the family's trees (CLIP's is drawn
  beside them by the harness), drawn from `gen` (harness/weights.py);
- `model_config(config)`: the port's model config of the file's geometry;
- `block_rows(config, pop, block)`: the rows the reference scores at once;
- `targets(config, weights, targets, device)`: each search's target as the
  reference encodes it;
- `score(config, weights, x, target)`: the reference's fitness columns of
  the genomes x against one search's target, the share of the image's
  pixels at the clip limits and D's logits (or None);
- `flops_per_candidate(config)`: the frozen model FLOPs to score a candidate
  (benchmark/yardstick/flops.py).

and may give, where it departs from a text-to-image family:
- `draw_targets(config, rng, n, workdir)`: the run's n targets, which the
  port is handed and `targets` later reads, drawn from `rng` (files go
  into `workdir`); without it, n text prompts (harness/prompts.py);
- `GENERATOR_OUTPUT`: (module, class, attribute) of the port's call whose
  results are kept beside each evaluation of the window
  (harness/trace.py) and handed to `score` as `outputs`, that search's
  rows of them; `score` then judges them (its result's `margins`), and
  without them makes its own (`outputs`). A family with no image gives
  `clipped` None;
- `LAYER_FUNCTIONS`: (module, function, span) entries of the port's
  functions that a traced run of the family's cells wraps beside the
  harness's own (harness/trace.py), with the same wrapper: CUDA events in
  the timed phase, host spans in the profiled one, the rows from the first
  argument after the weights, the attribute restored after.
"""

from __future__ import annotations

import dataclasses
import importlib


def family(config: dict):
    """The module of `config`'s model family."""
    return importlib.import_module(f"benchmark.families.{config['family']}")


def replace_fields(cfg, group: dict):
    """A port config dataclass with the fields that `group` names."""
    names = {f.name for f in dataclasses.fields(cfg)}
    fix = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v)
               if isinstance(v, list) else v) for k, v in group.items() if k in names}
    return dataclasses.replace(cfg, **fix)
