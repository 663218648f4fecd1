"""Known-clean twin of bad_fma: the same arithmetic outside compiled bodies,
or with no product feeding a sum inside them."""
import torch


def blend(x, y, w):
    return x * w + y  # clean: eager torch rounds the product and the sum apart


@torch.compile
def ratio(x, y, s):
    return x / s + y  # clean: a division feeding the add


@torch.compile
def scale(x, s):
    return x * s  # clean: no add


def plain(a, b, c):
    return a * b + c


plain_fn = torch.jit.script  # clean: the compiler named, not applied
