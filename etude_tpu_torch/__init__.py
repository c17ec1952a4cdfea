"""Etude in PyTorch for one NVIDIA H100: the port of the JAX package
`etude_tpu` (which stays in the repository as the reference).

It imports torch, numpy and scipy and nothing of JAX or of `etude_tpu`;
modules it needs from there that do not touch JAX (vocab, tokenizer,
training dataset, MIDI, logger, beat analyzer, octave pass, the DBN
decoder's C++) are its own copies. Importing it sets no environment variables, builds nothing and
touches no device.

Layout (mirrors etude_tpu/):
  config.py    settings dataclasses (Extract, Structuralize, Decode, training)
  weights.py   the JAX parameter trees ⇄ decoder (both ways); → Beat-Transformer,
               separator, hFT
  infer.py     the inference CLI (python -m etude_tpu_torch.infer --input / --decode-only)
  train.py     the decoder's training CLI (python -m etude_tpu_torch.train)
  parallel/    the training step (AdamW with accumulation and skip) and the
               host→device batch prefetcher, on one device
  utils/       logger, device, timing spans, audio and MIDI I/O, weight loading,
               training.py: seeding and the checkpoint format (params.npz)
  data/        vocab, REMI tokenizer, training dataset, separation, extractor,
               beat detector, beat analyzer
  models/      decoder (with its loss), streaming generation engine, separator
               U-Net, Beat-Transformer, hFT transcriber
  ops/         sampling, mel/DFT, DBN, octave pass, decode and dilated attention
               (CUDA kernels + plain versions), the nvcc/g++ build
  csrc/        CUDA C++ sources
  native/      host C++ (the DBN Viterbi decoder)
"""

__version__ = "0.1.0"
