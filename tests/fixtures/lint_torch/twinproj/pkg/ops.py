def packaged(x, scale):
    return x * scale
