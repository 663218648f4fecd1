"""Known-clean twin of core/bad_fused: the same fused ops outside the
bit-exact modules (models are held at a tolerance), and the two-op form."""
import torch


def ewma(mean, x, alpha):
    a = torch.addcmul(mean, x, alpha)
    b = mean.lerp(x, alpha)
    return a, b, mean + x * alpha
