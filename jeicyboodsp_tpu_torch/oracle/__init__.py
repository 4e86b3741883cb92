"""float64 numpy references of the reference programs (counterpart of
``jeicyboodsp_tpu/oracle/``, with the same module names).

Each module reproduces one reference C++ program's observable output
stream, quirks included, in float64 on the host; a CPU test holds each one
byte-identical to the JAX package's oracle of the same name.  They import
numpy only (``cnum`` holds the helpers they share), so the card tests
(``tests/test_torch_cuda.py``) and ``utils.gpu_checks`` hold the port to
them on a card's host, which has no JAX.  Each program's module exposes
``run`` (``nlms``: ``run_nlms`` and ``run_bnlms``) under the JAX oracle's
signature; ``gmm`` and ``viterbi`` expose the training, scoring and
decoding steps.  They are slow and
simple by design.
"""
