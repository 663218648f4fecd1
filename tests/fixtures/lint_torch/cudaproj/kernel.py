"""CUDA fixture's libraries: one built with contraction (nvcc's default),
one without, and one source (orphan.cu) that no call builds."""
from .build import load_library

STRICT_FLAGS = ("--fmad=false",)


def load():
    return (load_library("contracted", ["contracted.cu"]),
            load_library("strict", ["strict.cu"], extra_flags=STRICT_FLAGS))
