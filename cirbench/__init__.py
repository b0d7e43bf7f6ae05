"""The benchmark of the PyTorch/CUDA port (``candidate_reranking_cir_tpu_torch``);
``python3 -m cirbench.run --help``."""
