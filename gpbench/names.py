"""Parts of the benchmark found by name: gpbench/<folder>/<stem>.py of the
checkout at `root`, loaded from its file. A traffic mix names its mode
(modes/<mode>.py), a configuration its model (models/<oi_model>.py), a
metric its reader (metrics/<name>.py)."""

import importlib.util
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LOADED = {}


def load(folder, stem, root=ROOT):
    """The module gpbench/<folder>/<stem>.py under `root`; raises
    FileNotFoundError where there is none."""
    path = os.path.join(root, "gpbench", folder, stem + ".py")
    if path not in _LOADED:
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        spec = importlib.util.spec_from_file_location(
            f"gpbench_{folder}_{stem}".replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]
