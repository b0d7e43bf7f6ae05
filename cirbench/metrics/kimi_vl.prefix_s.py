"""Mean over the window's calls of the prefix scorer's layer span
``seconds['prefix']`` (every chunk's causal pass over its queries'
reference tokens and captions, keeping each layer's latent; each chunk's
span ends in a device sync), in seconds."""


def read(run: dict):
    spans = [c["seconds"]["prefix"] for c in run["calls"]
             if "prefix" in c["seconds"]]
    return sum(spans) / len(spans) if spans else None
