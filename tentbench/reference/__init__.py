"""Plain float32 references of the served model families, one module a
family, named by a configuration's `reference` key. They import nothing of
the program."""
