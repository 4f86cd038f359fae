"""The port's tokenizers against the JAX package's: CLIP BPE ids from
``make_test_tokenizer`` (a byte-level vocabulary plus a few merged words;
the real vocabulary is not in the repository) and the HashTokenizer's zlib
CRC ids, exactly equal; get_tokenizer's rule for the hash fallback; and the
``regex`` package needed only by the BPE path."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
WORDS = ("photo", "astronaut", "riding", "horse", "masterpiece")
TEXTS = ["a photo of an astronaut riding a horse", "Masterpiece, best quality, 1girl, solo",
         "caf\u00e9 na\u00efve r\u00e9sum\u00e9 \u2014 \U0001f600 emoji", "  spaced\tout &amp; escaped  ", "",
         "it's a dog's life, isn't it? 12345 67", "x" * 200]


@pytest.mark.parametrize("text", TEXTS)
def test_bpe_ids_equal_jax(text):
    pytest.importorskip("regex")
    from neurosis_tpu.models.text_encoder.tokenizer import make_test_tokenizer as jax_make

    from neurosis_tpu_torch.models.text_encoder.tokenizer import make_test_tokenizer

    ours, theirs = make_test_tokenizer(WORDS, max_length=16), jax_make(WORDS, max_length=16)
    assert ours.encode(text) == theirs.encode(text)
    np.testing.assert_array_equal(ours([text, "photo horse"]), theirs([text, "photo horse"]))
    np.testing.assert_array_equal(ours.tokenize_extended([text], 3), theirs.tokenize_extended([text], 3))
    assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text))


@pytest.mark.parametrize("texts", [TEXTS, ["one"], [""]])
def test_hash_tokenizer_ids_equal_jax(texts):
    pytest.importorskip("jax")
    from neurosis_tpu.trainer.loop import HashTokenizer as JaxHash

    from neurosis_tpu_torch.trainer.loop import HashTokenizer

    for max_length in (77, 8):
        np.testing.assert_array_equal(HashTokenizer()(texts, max_length), JaxHash()(texts, max_length))


def test_get_tokenizer_falls_back_only_when_allowed(tmp_path, monkeypatch):
    from neurosis_tpu_torch.trainer.loop import HashTokenizer, get_tokenizer

    monkeypatch.delenv("NEUROSIS_TOKENIZER_DIR", raising=False)
    monkeypatch.delenv("NEUROSIS_ALLOW_HASH_TOKENIZER", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="NEUROSIS_ALLOW_HASH_TOKENIZER"):
        get_tokenizer()
    assert isinstance(get_tokenizer(allow_fallback=True), HashTokenizer)
    monkeypatch.setenv("NEUROSIS_ALLOW_HASH_TOKENIZER", "1")
    assert isinstance(get_tokenizer(), HashTokenizer)


def test_vocab_dir_is_read(tmp_path, monkeypatch):
    """An HF-layout vocabulary (vocab.json + merges.txt) under
    NEUROSIS_TOKENIZER_DIR gives the BPE tokenizer, with the same ids."""
    pytest.importorskip("regex")
    import json

    from neurosis_tpu_torch.models.text_encoder.tokenizer import CLIPTokenizer, make_test_tokenizer
    from neurosis_tpu_torch.trainer.loop import get_tokenizer

    ref = make_test_tokenizer(WORDS, max_length=77)
    (tmp_path / "vocab.json").write_text(json.dumps(ref.encoder))
    merges = sorted(ref.bpe_ranks, key=ref.bpe_ranks.get)
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    monkeypatch.setenv("NEUROSIS_TOKENIZER_DIR", str(tmp_path))
    tok = get_tokenizer()
    assert isinstance(tok, CLIPTokenizer)
    np.testing.assert_array_equal(tok(TEXTS), ref(TEXTS))


def test_without_regex_the_hash_path_works_and_bpe_raises(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['regex'] = None\n"
        "from neurosis_tpu_torch.trainer.loop import HashTokenizer, get_tokenizer\n"
        "from neurosis_tpu_torch.models.text_encoder.tokenizer import make_test_tokenizer\n"
        "assert isinstance(get_tokenizer(allow_fallback=True), HashTokenizer)\n"
        "try:\n"
        "    make_test_tokenizer(['photo'])\n"
        "except ImportError as e:\n"
        "    assert 'regex' in str(e), e\n"
        "    print('raised')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "NEUROSIS_TOKENIZER_DIR"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**env, "HF_HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
