"""real_tpu_torch — the PyTorch/CUDA port of real_tpu.

The same short-read aligner as `real_tpu`, written in PyTorch for one
NVIDIA H100, with the Pallas window gather replaced by a hand-written CUDA
kernel (ops/gather.py, csrc/gather_windows.cu). The layout mirrors
`real_tpu` module for module. The package imports torch and numpy only —
nothing of JAX and nothing of `real_tpu`.

Entry points (engine.driver.load_texts / run_match_unique, cli.main) run on
the card unless the caller passes device="cpu"; without CUDA they raise.
"""
