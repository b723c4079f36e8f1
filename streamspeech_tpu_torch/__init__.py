"""streamspeech_tpu_torch: the PyTorch/CUDA port of streamspeech_tpu for NVIDIA Hopper.

The JAX package (``streamspeech_tpu``) is the reference; this package mirrors its
layout so each module's counterpart is easy to find:

- ``ops``      host frontend (fbank, CMVN), masks, 1-D convolutions, CTC collapse.
- ``models``   chunk Conformer encoder, MT decoder, T2U encoder, NAR unit decoder,
               unit HiFi-GAN vocoder (``nn.Module``s, batch-first ``[B, T, C]``).
- ``kernels``  Python wrappers of the hand-written CUDA kernels (plain PyTorch
               version beside each, launch counters).
- ``csrc``     CUDA C++ sources, compiled with ``nvcc`` at first use.
- ``runtime``  the streaming engine and per-utterance session.
- ``agents``   the simultaneous S2ST agent (SimulEval-style push/pop).

Importing this package never imports ``jax``, ``flax`` or ``streamspeech_tpu``.
"""

__version__ = "0.1.0"
