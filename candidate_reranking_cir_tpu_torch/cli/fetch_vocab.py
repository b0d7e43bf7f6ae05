"""Fetch bert-base-uncased's WordPiece vocabulary into a local cache (port
of the JAX package's ``cli/fetch_vocab.py``).

The reference obtains the vocabulary from the HuggingFace hub at every run
(blip.py:186-191, ``BertTokenizer.from_pretrained('bert-base-uncased')``).
Here the 30,522-line ``vocab.txt`` is fetched once into a cache, and every
CLI takes it through ``--vocab``, offline afterwards. The [DEC]/[ENC]
tokens (ids 30522/30523) are appended by the tokenizer at load time
(``models/tokenizer.py``), so the file stays byte-identical to the
published one. The tool checks the 30,522-line shape and prints the
sha256; ``--expect-sha256`` pins an exact digest.

    python -m candidate_reranking_cir_tpu_torch.cli.fetch_vocab
    python -m candidate_reranking_cir_tpu_torch.cli.fetch_vocab --out ./vocab.txt
"""
from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

# the published sources, tried in order
URLS = (
    "https://huggingface.co/bert-base-uncased/resolve/main/vocab.txt",
    "https://huggingface.co/google-bert/bert-base-uncased/resolve/main/"
    "vocab.txt",
)
BASE_VOCAB_SIZE = 30522


def default_cache_path() -> Path:
    return (Path.home() / ".cache" / "candidate_reranking_cir_tpu"
            / "vocab" / "bert-base-uncased-vocab.txt")


def validate_vocab_file(path: Path, *, expect_sha256: str = "") -> dict:
    """Check a vocabulary file: 30,522 entries, and the exact digest when
    the caller pins one. Returns {'lines', 'sha256'}."""
    data = Path(path).read_bytes()
    n_lines = len(data.decode("utf-8").splitlines())
    digest = hashlib.sha256(data).hexdigest()
    if n_lines != BASE_VOCAB_SIZE:
        raise ValueError(
            f"{path}: expected {BASE_VOCAB_SIZE} vocab entries, found "
            f"{n_lines}: not the published bert-base-uncased vocab.txt")
    if expect_sha256 and digest != expect_sha256.lower():
        raise ValueError(f"{path}: sha256 {digest} != expected "
                         f"{expect_sha256}")
    return {"lines": n_lines, "sha256": digest}


def fetch(out: Path, *, expect_sha256: str = "",
          force: bool = False) -> Path:
    """``out`` when it already holds a valid vocabulary (and not
    ``force``), else a download from ``URLS`` into it, checked before it
    takes the name."""
    from urllib.request import urlretrieve

    if out.exists() and not force:
        info = validate_vocab_file(out, expect_sha256=expect_sha256)
        print(f"cached: {out} ({info['lines']} entries, "
              f"sha256 {info['sha256']})")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    last_err: Exception | None = None
    for url in URLS:
        try:
            print(f"fetching {url} ...")
            tmp = out.with_suffix(".part")
            urlretrieve(url, tmp)
            info = validate_vocab_file(tmp, expect_sha256=expect_sha256)
            tmp.rename(out)
            print(f"saved {out} ({info['lines']} entries, "
                  f"sha256 {info['sha256']})")
            return out
        except Exception as e:  # noqa: BLE001 - try the mirror, then report
            last_err = e
    raise RuntimeError(
        f"could not fetch vocab.txt from any source ({last_err!r}); on a "
        "machine without network access, copy bert-base-uncased's "
        f"vocab.txt here: {out}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=str, default="",
                        help=f"destination (default: {default_cache_path()})")
    parser.add_argument("--expect-sha256", type=str, default="",
                        help="pin the exact digest of the fetched file")
    parser.add_argument("--force", action="store_true",
                        help="download again even if cached")
    args = parser.parse_args(argv)
    out = Path(args.out) if args.out else default_cache_path()
    path = fetch(out, expect_sha256=args.expect_sha256, force=args.force)
    print(f"\nuse with every CLI:  --vocab {path}")


if __name__ == "__main__":
    sys.exit(main())
