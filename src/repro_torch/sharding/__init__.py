"""Sharding rules and the activation-sharding context on a `DeviceMesh`
(counterpart of `repro.sharding`)."""
