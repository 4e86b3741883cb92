"""Per-layer readers, one file a metric (``<metric>.py``, loaded by path by
:func:`portbench.harness.reader`): each defines ``read(r)`` over a
:class:`portbench.harness.Reading` and returns a number, or None where the
window holds nothing it can read."""
