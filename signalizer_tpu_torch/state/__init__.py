"""Versioned keyed-tree serialization (the port's copy of :mod:`signalizer_tpu.state`'s serializer)."""
