"""PyTorch/CUDA port of candidate_reranking_cir_tpu for NVIDIA Hopper.

Imports torch and numpy only. The evaluation entry points are
``retrieval.validate_engine.evaluate_{cirr,fiq}_stage1`` (stage I: the
top-K file) and ``retrieval.validate2_engine.evaluate_{cirr,fiq}_stage2``
(stage II: its re-rank), with the CLIs in ``cli/``.
"""
