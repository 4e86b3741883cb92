"""The benchmark's plain reference: what decides ``correct``.

A frozen copy of the reference programs' float64 semantics (``cnum``,
``enhance``, ``nlms``), in NumPy and plain PyTorch, with no import of the
program under test.  It works everything out again from the inputs the
harness hands to both sides, the sessions' state included, and reads the
program's outputs only to judge them.  ``precision`` rounds a stage's values
to a lower precision, which turns the same code into the control.
"""
