"""The Lite trainer's experiment configs, the port of
autoware_vision_pilot_tpu/train/lite_trainer.py::load_experiment_config.

Only the config reader that export/eval_lite.py needs is ported. The
Lite trainer itself (its optimizers, schedules, train loop and resume)
waits for ROADMAP Queue 1 item 6.5.
"""
from __future__ import annotations

import pathlib
from typing import Any, Dict


def load_experiment_config(path: str | pathlib.Path) -> Dict[str, Any]:
    """A YAML experiment config (configs/*Lite.yaml) -> its dict."""
    import yaml  # PyYAML: only the config readers need it

    with open(path) as f:
        return yaml.safe_load(f)
