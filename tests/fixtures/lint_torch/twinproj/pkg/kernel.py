"""Twin-drift fixture: a kernel module whose registry names its twins as
names bound through imports, as strings and as (twin, reason) waivers."""
from .ref import chained_ref, drifted_ref, good_ref, untested_ref, waived_ref
from .ref import good_ref as aliased_ref

__torch_twins__ = {
    "good": good_ref,  # clean: a name imported from ref.py, params match
    "packaged": aliased_ref,  # clean: the key's def lives in ops.py beside this module
    "chained": chained_ref,  # clean: ref.py re-exports it from impl.py
    "waived": (waived_ref, "packed buffers against the twin's arrays"),  # clean waiver
    "by_string": "good_ref",  # clean: a string names a def in engine source
    "drifted": drifted_ref,  # VIOLATION: parameter names drifted
    "bare_waiver": (waived_ref, ""),  # VIOLATION: a waiver without a reason
    "missing": good_ref,  # VIOLATION: no def `missing` here or in the package
    "orphan": "no_such_twin",  # VIOLATION: the twin is no def
    "untested": untested_ref,  # VIOLATION: no parity test names both
}


def good(x, scale):
    return x * scale


def chained(x):
    return x


def waived(buf, n):
    return buf[:n]


def by_string(x, scale):
    return x * scale


def drifted(x, alpha):
    return x + alpha


def bare_waiver(buf):
    return buf


def orphan(x):
    return x


def untested(x):
    return abs(x)


def scale_torch(x, s):  # clean: unregistered, twin `scale` by the strip-_torch convention
    return x * s


def lonely_torch(x):  # VIOLATION: unregistered and no def `lonely` anywhere
    return x


def _private_torch(x):  # underscore-private: outside the twin contract
    return x
