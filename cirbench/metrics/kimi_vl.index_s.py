"""``rerank.index_s``'s reading in the Kimi-VL cell: the mean over the
window's calls of the layer span ``seconds['index']`` (MoonViT and the
projector over the corpus, the bank's staging included), in seconds."""
from cirbench import harness

read = harness.load_module("metrics", "rerank.index_s").read
