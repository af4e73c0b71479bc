"""Shipped kernel libraries: build once, load on hosts without ``nvcc``.

Counterpart of :mod:`cvmatrix_tpu.utils.aot`. A JAX artifact holds a traced
and lowered program for a fleet. The port's compiled artifacts are its
kernel libraries: :func:`export_kernels` builds every ``csrc/*.cu`` and
writes the libraries with a manifest of their build keys (source, flags,
``nvcc`` version; :func:`cvmatrix_tpu_torch.ops._build.kernel_key`), and
:func:`load_kernels` makes the loader use them, so the first launch on a
serving host loads a library instead of running ``nvcc``.

The traced-program half of ``export_program`` has no counterpart: torch
runs eagerly, so there is no program to trace, lower or ship, and shapes
and dtypes are checked at each call.
"""

from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

from ..ops import _build

__all__ = ["export_kernels", "load_kernels"]

MANIFEST = "manifest.json"


def export_kernels(path: str) -> dict:
    """Build every kernel source of the checkout (one ``nvcc`` each, all at
    once) and write the libraries and ``manifest.json`` to ``path``;
    returns the manifest. Needs ``nvcc``; raises on a failed build."""
    names = _build.library_names()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(_build.library_path, names)))
    os.makedirs(path, exist_ok=True)
    libraries = {}
    for name, (so_path, key, version) in built.items():
        fname = os.path.basename(so_path)
        tmp = os.path.join(path, f"{fname}.tmp{os.getpid()}")
        shutil.copyfile(so_path, tmp)
        os.replace(tmp, os.path.join(path, fname))
        libraries[name] = {"file": fname, "key": key, "nvcc": version}
    manifest = {"nvcc_flags": list(_build.NVCC_FLAGS),
                "libraries": libraries}
    tmp = os.path.join(path, f"{MANIFEST}.tmp{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, MANIFEST))
    return manifest


def load_kernels(path: str) -> Dict[str, str]:
    """Use the libraries :func:`export_kernels` wrote to ``path`` for every
    later launch in this process; returns ``{name: library path}``.

    Each kernel source of the checkout must be in the manifest with the key
    its source and this checkout's flags give under the manifest's ``nvcc``
    version, and its file must exist; otherwise this raises ``ValueError``
    and changes nothing. It never builds a library, and never falls back to
    another. Libraries already loaded in this process are dropped, so the
    next launch loads the shipped ones.
    """
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("nvcc_flags") != list(_build.NVCC_FLAGS):
        raise ValueError(f"{path}: built with flags "
                         f"{manifest.get('nvcc_flags')}, this checkout uses "
                         f"{list(_build.NVCC_FLAGS)}")
    libraries = manifest.get("libraries", {})
    found = {}
    for name in _build.library_names():
        entry = libraries.get(name)
        if entry is None:
            raise ValueError(f"{path}: no library for csrc/{name}.cu")
        want = _build.kernel_key(name, entry["nvcc"])
        if entry["key"] != want:
            raise ValueError(
                f"{path}: csrc/{name}.cu was built with key {entry['key']}; "
                f"this checkout's source and flags give {want} (a library "
                "built from other sources)")
        so_path = os.path.join(os.path.abspath(path), entry["file"])
        if not os.path.isfile(so_path):
            raise ValueError(f"{path}: {entry['file']} is missing")
        found[name] = so_path
    with _build._LOCK:
        _build._SHIPPED.update(found)
        for name in found:
            _build._LIBS.pop(name, None)
    return found
