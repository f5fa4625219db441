"""The port's model zoo (counterpart of ``marie_tpu/registry/zoo.py``):
trained trees as ``<repo>/torch_zoo/<name>.npz``, written from the JAX
package's ``model_zoo/`` checkpoints by ``scripts/export_torch_zoo.py``.
The directory also holds the pages, truth and golden results that
``chip_smoke.py`` and the tests check the trees with.
"""

import os
from typing import Any, Dict, Optional

from marie_tpu_torch.registry.checkpoints import load_params

ZOO_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "torch_zoo",
)


def zoo_checkpoint(name: str) -> Optional[str]:
    """The ``.npz`` file of a zoo tree by name, or None when absent."""
    path = os.path.join(ZOO_DIR, f"{name}.npz")
    return path if os.path.isfile(path) else None


def zoo_params(name: str) -> Optional[Dict[str, Any]]:
    """A zoo tree as nested numpy dicts, or None when absent."""
    path = zoo_checkpoint(name)
    return None if path is None else load_params(path)
