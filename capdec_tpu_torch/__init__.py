"""capdec_tpu_torch — the PyTorch/CUDA port of capdec_tpu for NVIDIA Hopper.

A second package beside `capdec_tpu/` (the JAX reference, which it never
imports). Its modules mirror the JAX package's paths and names so each
counterpart is easy to find:

  models/    GPT-2 LM, the mapper family, the caption model
  ops/       the hand-written Hopper kernels (csrc/*.cu) beside their
             plain PyTorch versions, and the kernel build
  decode/    the beam-search and greedy/top-p engines
  train/     the train step, optimizer, loop and resume
  eval/      the predictions runner, metrics, ablation stats, prefix tools
  aux/       the modality offset and the bridger
  data/      the caption dataset
  utils/     tokenizer, checkpoint and config IO, meters, FLOPs, device
  serve.py   the batch-serving loop
  cli/       serve, train, predict and inspect_prefixes

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`); without a card and without that request they raise.
"""

__version__ = "0.1.0"
