"""PyTorch/CUDA port of candidate_reranking_cir_tpu for NVIDIA Hopper.

Imports torch and numpy only. The stage-II re-rank evaluation entry point is
``retrieval.validate2_engine.evaluate_cirr_stage2``.
"""
