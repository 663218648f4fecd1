"""Meshes, the roofline, op accounting and the multi-pod dry run
(counterpart of `repro.launch`)."""
