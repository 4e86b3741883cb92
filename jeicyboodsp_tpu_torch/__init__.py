"""JeicybooDSP on PyTorch and CUDA: the port of :mod:`jeicyboodsp_tpu`.

Same subfolder names as the JAX package, so each module's counterpart is
found at the same path:

- ``ops``       torch ops around the kernels (the latch row pack, the
                enhancement chain's entry points and constant bases; the
                GEQ and the NLMS/BNLMS echo cancellers; MFCC and pitch;
                the matmul DFTs; the RIR fast convolution; the FFT
                roundtrip program; the MVDR beamformer; the AWGN harness).
- ``models``    GMM training and scoring, HMM/Viterbi decoding and
                training; the reference's struct model files and pytree
                checkpoints (the JAX package's npz layout).
- ``kernels``   wrappers of the hand-written Hopper kernels, each beside its
                plain PyTorch version and a launch counter; ``_build``
                compiles ``csrc/`` with nvcc at first use.
- ``csrc``      CUDA C++ sources (sm_90a).
- ``io``        PCM16 file I/O; streaming sessions with checkpoint/resume.
- ``pipelines`` file-in/file-out pipelines, all 17 of the JAX package's
                (wiener, specsub, geq, nlms, bnlms, pitch1-3, mfcc,
                fastconv, fft, mvdr, awgn, gmm-train, gmm-test, viterbi,
                stream), and speech training, classification and decoding
                from raw audio.
- ``parallel``  process groups and meshes over ``torch.distributed``, halo
                exchange and sharded scans, every sharded path of the JAX
                package and the sharded speech pipeline.
- ``config``    the engines' fidelity floors and the programs' configurations.
- ``utils``     C-numeric emulation (``c_short``), SNR and the metrics
                registry, the entry device.

The package imports torch and numpy only: never jax, never
``jeicyboodsp_tpu``.  Ported so far: the Wiener / spectral-subtraction chain
through engines ``mxu8f``, ``mxu8t`` (with the VAD kernel K14), ``mxu8`` and
``mxu3``, and the two-kernel f32 engine ``_enhance_fused`` (K4, K13); the
7-band GEQ (kernels K6, K7); the NLMS and BNLMS echo cancellers (K8, K9);
MFCC (K10) with GMM classification, and pitch (K11 for the AMDF of method
2); the RIR fast convolution and the FFT program, whose four-step engines
run the four-step FFT K12; the 2-mic MVDR beamformer; streaming with
checkpoint/resume (the enhancement, GEQ and echo-canceller sessions and the
resumable ``stream`` pipeline); speech recognition (GMM training with the
reference's model files, HMM/Viterbi decoding, ``speech_train`` and
``speech_decode``) and the AWGN harness, as torch ops; the sharded paths
over ``torch.distributed``, the sharded speech pipeline (training,
classification through K10, decoding) among them.  Every TPU kernel of the
JAX package has its counterpart here.
"""

__version__ = "0.1.0"
