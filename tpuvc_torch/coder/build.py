"""Compile-on-first-use build of the native rANS library (g++, plain C ABI
consumed through ctypes) into the port's build directory."""

from __future__ import annotations

import os

from tpuvc_torch.utils.native import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "rans.cpp")


def lib_path() -> str:
    """Path to the compiled shared object, building it if needed."""
    return build_library(
        "tpuvc_rans", [_SRC],
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall", "-Werror"],
    )
