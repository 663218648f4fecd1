"""The plain versions the kernel module's registry names."""
from .impl import chained_impl as chained_ref

__all__ = ["chained_ref", "drifted_ref", "good_ref", "scale", "untested_ref", "waived_ref"]


def good_ref(x, scale):
    return x * scale


def drifted_ref(x, beta):
    return x + beta


def waived_ref(data, count):
    return data[:count]


def untested_ref(x):
    return abs(x)


def scale(x, s):
    return x * s
