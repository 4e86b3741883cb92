"""JeicybooDSP on PyTorch and CUDA: the port of :mod:`jeicyboodsp_tpu`.

Same subfolder names as the JAX package, so each module's counterpart is
found at the same path:

- ``ops``       torch ops around the kernels (the latch row pack, the
                enhancement chain's entry points and constant bases; the
                GEQ and the NLMS/BNLMS echo cancellers; MFCC and pitch;
                the matmul DFTs; the RIR fast convolution; the FFT
                roundtrip program).
- ``models``    the GMM class scorer; pytree checkpoints (the JAX
                package's npz layout).
- ``kernels``   wrappers of the hand-written Hopper kernels, each beside its
                plain PyTorch version and a launch counter; ``_build``
                compiles ``csrc/`` with nvcc at first use.
- ``csrc``      CUDA C++ sources (sm_90a).
- ``io``        PCM16 file I/O; streaming sessions with checkpoint/resume.
- ``pipelines`` file-in/file-out pipelines (wiener, specsub, geq, nlms,
                bnlms, pitch1-3, mfcc, fastconv, fft, mvdr, stream) and
                speech classification.
- ``utils``     C-numeric emulation (``c_short``), SNR, the entry device.

The package imports torch and numpy only: never jax, never
``jeicyboodsp_tpu``.  Ported so far: the Wiener / spectral-subtraction chain
through engines ``mxu8f``, ``mxu8t`` (with the VAD kernel K14), ``mxu8`` and
``mxu3``, and the two-kernel f32 engine ``_enhance_fused`` (K4, K13); the
7-band GEQ (kernels K6, K7); the NLMS and BNLMS echo cancellers (K8, K9);
MFCC (K10) with GMM classification, and pitch (K11 for the AMDF of method
2); the RIR fast convolution and the FFT program, whose four-step engines
run the four-step FFT K12; the 2-mic MVDR beamformer; streaming with
checkpoint/resume (the enhancement, GEQ and echo-canceller sessions and the
resumable ``stream`` pipeline).  Every TPU kernel of the JAX package has its
counterpart here.
"""

__version__ = "0.1.0"
