"""CUDA fixture's build module: the common nvcc flags and the loader."""
NVCC_FLAGS = ("-O3", "-shared")


def load_library(name, sources, extra_flags=()):
    return name, sources, extra_flags
