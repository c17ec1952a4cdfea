"""Etude in PyTorch for one NVIDIA H100: the port of the JAX package
`etude_tpu` (which stays in the repository as the reference).

It imports torch, numpy and scipy and nothing of JAX or of `etude_tpu`;
modules it needs from there that do not touch JAX (vocab, tokenizer,
training dataset, synthetic corpora, onset F1, MIDI, logger, beat
analyzer, octave pass, the DBN decoder's C++) are its own copies. Importing it sets no environment variables, builds nothing and
touches no device.

Layout (mirrors etude_tpu/):
  config.py    settings dataclasses (Extract, Structuralize, Decode, training)
  weights.py   the JAX parameter trees ⇄ decoder, Beat-Transformer, separator,
               hFT (both ways)
  infer.py     the inference CLI (python -m etude_tpu_torch.infer --input / --decode-only)
  train.py     the decoder's training CLI (python -m etude_tpu_torch.train)
  train_aux.py the auxiliary models' training CLI on synthetic corpora
               (python -m etude_tpu_torch.train_aux {beat,amt,separator,all})
  parallel/    the training steps (AdamW with accumulation and skip; the aux
               models' AdamW) and the host batch prefetchers, on one device
  utils/       logger, device, timing spans, audio and MIDI I/O, weight loading,
               training.py: seeding and the checkpoint format (params.npz)
  data/        vocab, REMI tokenizer, training dataset, synthetic corpora,
               separation, extractor, beat detector, beat analyzer
  models/      decoder, separator U-Net, Beat-Transformer, hFT transcriber (each
               with its loss), streaming generation engine
  ops/         sampling, mel/DFT, DBN, octave pass, decode and dilated attention
               (CUDA kernels, the latter with its backward, + plain versions),
               the nvcc/g++ build
  evaluation/  metrics (onset F1)
  csrc/        CUDA C++ sources
  native/      host C++ (the DBN Viterbi decoder)
"""

__version__ = "0.1.0"
