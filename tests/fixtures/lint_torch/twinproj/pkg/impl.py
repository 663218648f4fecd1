def chained_impl(x):
    return x
