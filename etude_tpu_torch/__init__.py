"""Etude in PyTorch for one NVIDIA H100: the port of the JAX package
`etude_tpu` (which stays in the repository as the reference).

It imports torch, numpy and scipy and nothing of JAX or of `etude_tpu`;
modules it needs from there that do not touch JAX (vocab, tokenizer,
training dataset, synthetic corpora, the metrics, MIDI, logger, beat
analyzer, octave pass, preprocess helpers, the DBN decoder's and the banded
DTW's C++) are its own copies. Importing it sets no environment variables, builds nothing and
touches no device.

Layout (mirrors etude_tpu/):
  config.py    settings dataclasses (Extract, Structuralize, Decode, training,
               data preparation, evaluation)
  weights.py   the JAX parameter trees ⇄ decoder, Beat-Transformer, separator,
               hFT (both ways)
  infer.py     the inference CLI (python -m etude_tpu_torch.infer --input / --decode-only)
  train.py     the decoder's training CLI (python -m etude_tpu_torch.train)
  train_aux.py the auxiliary models' training CLI on synthetic corpora
               (python -m etude_tpu_torch.train_aux {beat,amt,separator,all})
  prepare.py   dataset preparation, stages 2-5 (python -m etude_tpu_torch.prepare)
  evaluate.py  WPD / RGC / IPE of rendered covers (python -m etude_tpu_torch.evaluate)
  parallel/    the training steps (AdamW with accumulation and skip; the aux
               models' AdamW) and the host batch prefetchers, on one device
  utils/       logger, device, timing spans, audio and MIDI I/O, weight loading,
               training.py: seeding and the checkpoint format (params.npz),
               preprocess.py: WP-Std, time maps, weak alignment
  data/        vocab, REMI tokenizer, training dataset, synthetic corpora,
               separation, extractor, beat detector, beat analyzer, hFT
               stride transcriber, audio aligner
  models/      decoder, separator U-Net, Beat-Transformer, hFT transcriber (each
               with its loss), streaming generation engine
  ops/         sampling, mel/DFT, DBN, octave pass, chroma, DTW (wavefront on
               the device, banded DP on the host), decode and dilated
               attention (CUDA kernels, the latter with its backward, + plain
               versions), the nvcc/g++ build
  evaluation/  metrics (WPD, RGC, IPE with its own k-means, onset F1), runner,
               report
  csrc/        CUDA C++ sources
  native/      host C++ (the DBN Viterbi decoder, the banded DTW)
"""

__version__ = "0.1.0"
