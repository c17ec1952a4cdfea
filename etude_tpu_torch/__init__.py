"""Etude in PyTorch for one NVIDIA H100: the port of the JAX package
`etude_tpu` (which stays in the repository as the reference).

It imports torch, numpy and scipy and nothing of JAX or of `etude_tpu`;
modules it needs from there that do not touch JAX (vocab, tokenizer, MIDI,
logger, beat analyzer, octave pass, the DBN decoder's C++) are its own
copies. Importing it sets no environment variables, builds nothing and
touches no device.

Layout (mirrors etude_tpu/):
  config.py    settings dataclasses (Structuralize and Decode)
  weights.py   the JAX parameter trees → decoder, Beat-Transformer, separator
  infer.py     Structuralize stage and decode-only CLI (python -m etude_tpu_torch.infer)
  utils/       logger, device, timing spans, audio and MIDI I/O, weight loading
  data/        vocab, REMI tokenizer, separation, beat detector, beat analyzer
  models/      decoder, streaming generation engine, separator U-Net, Beat-Transformer
  ops/         sampling, mel/DFT, DBN, octave pass, decode and dilated attention
               (CUDA kernels + plain versions), the nvcc/g++ build
  csrc/        CUDA C++ sources
  native/      host C++ (the DBN Viterbi decoder)
"""

__version__ = "0.1.0"
