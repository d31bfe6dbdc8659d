"""Config persistence helpers (PyTorch port of
``vit_prisma_tpu/utils/saving_utils.py``): a config dataclass (or any object
with attributes) to a JSON file, and back as a dict."""

import dataclasses
import json
import os


def save_config_to_file(config, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    d = dataclasses.asdict(config) if dataclasses.is_dataclass(config) \
        else dict(vars(config))
    with open(path, "w") as f:
        json.dump(d, f, indent=2, default=str)


def load_config_dict(path):
    with open(path) as f:
        return json.load(f)
