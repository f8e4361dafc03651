"""The text encoder's pretrained branch against the JAX package's, on the
CPU: a tiny CLIP text tower (with its projection) and a tiny BERT, saved
with `save_pretrained` in PyTorch and Flax weights into one directory each,
with a vocabulary (and BPE merges) written here. The JAX encoder loads the
Flax weights, the port the PyTorch ones; in the `clip`, `clip_hidden` and
`bert` modes their embeddings agree within 1e-5 of the max and
`token_mask` is equal. Without transformers the port refuses with an
ImportError naming it (the JAX encoder would fall back to hashed words), and
a directory without `config.json` is refused naming the file.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from seeme_tpu.models.text_encoder import ClipTextEncoder as JTextEncoder
from seeme_tpu_torch.models.text_encoder import ClipTextEncoder
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

os.environ.setdefault("USE_TF", "0")  # transformers would import TensorFlow too (10 s)
transformers = pytest.importorskip("transformers")

TEXTS = ["a person walks forward", "jump", "the man turns left and raises both hands slowly"]
WORDS = sorted({w for t in TEXTS for w in t.split()} | {"run"})


def save_flax(cls, path):
    """The directory's PyTorch weights as Flax weights beside them."""
    cls.from_pretrained(str(path), from_pt=True).save_pretrained(str(path))


def clip_dir(path):
    """CLIP tokenizer files over whole words (each word one BPE token) and
    a 2-layer, 32-wide text tower projecting to 24."""
    path.mkdir()
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab = {t: i for i, t in enumerate(letters + [f"{c}</w>" for c in letters])}
    merges = []
    for w in WORDS:  # merge each word left to right into one token
        cur = w[0]
        for i, ch in enumerate(w[1:], 1):
            nxt = ch + "</w>" if i == len(w) - 1 else ch
            merges.append(f"{cur} {nxt}")
            cur = cur + nxt
            vocab.setdefault(cur, len(vocab))
    for tok in ("<|startoftext|>", "<|endoftext|>"):
        vocab[tok] = len(vocab)
    (path / "vocab.json").write_text(json.dumps(vocab))
    (path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(dict.fromkeys(merges)) + "\n")
    tok = transformers.CLIPTokenizer(str(path / "vocab.json"), str(path / "merges.txt"),
                                     pad_token="<|endoftext|>")
    tok.save_pretrained(str(path))
    cfg = transformers.CLIPTextConfig(vocab_size=len(vocab), hidden_size=32,
                                      intermediate_size=64, num_hidden_layers=2,
                                      num_attention_heads=4, max_position_embeddings=16,
                                      projection_dim=24, bos_token_id=vocab["<|startoftext|>"],
                                      eos_token_id=vocab["<|endoftext|>"],
                                      pad_token_id=vocab["<|endoftext|>"])
    torch.manual_seed(0)
    model = transformers.CLIPTextModelWithProjection(cfg)
    model.save_pretrained(str(path))
    save_flax(transformers.FlaxCLIPTextModelWithProjection, path)
    return str(path)


def bert_dir(path):
    """A whole-word BERT vocabulary and a 2-layer, 32-wide BERT whose
    tokenizer caps captions at 12 tokens."""
    path.mkdir()
    (path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                                               *WORDS]) + "\n")
    transformers.BertTokenizer(str(path / "vocab.txt"), model_max_length=12) \
        .save_pretrained(str(path))
    cfg = transformers.BertConfig(vocab_size=5 + len(WORDS), hidden_size=32, intermediate_size=64,
                                  num_hidden_layers=2, num_attention_heads=4,
                                  max_position_embeddings=32)
    torch.manual_seed(1)
    transformers.BertModel(cfg).save_pretrained(str(path))
    save_flax(transformers.FlaxBertModel, path)
    return str(path)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("text")
    return {"clip": clip_dir(root / "tiny-clip"), "bert": bert_dir(root / "tiny-bert")}


@pytest.mark.parametrize("mode", ["clip", "clip_hidden", "bert"])
def test_pretrained_encoder_matches_jax(model_dirs, mode):
    path = model_dirs["bert" if mode == "bert" else "clip"]
    kw = dict(latent_dim=24 if mode == "clip" else 32, last_hidden_state=mode == "clip_hidden",
              max_length=16)
    ours, ref = ClipTextEncoder(path, **kw), JTextEncoder(path, **kw)
    assert ours.name == ref.name == mode
    assert not ours.is_fallback and not ref.is_fallback
    assert ours.max_length == ref.max_length == (12 if mode == "bert" else 16)
    a, b = ours(TEXTS), ref(TEXTS)
    assert a.shape == b.shape == ((3, 1, 24) if mode == "clip" else (3, ours.max_length, 32))
    assert a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()))
    mask = ours.token_mask(TEXTS)
    if mode == "clip":
        assert mask is None and ref.token_mask(TEXTS) is None
    else:
        np.testing.assert_array_equal(mask, ref.token_mask(TEXTS))
        assert mask[1].sum() == 3  # bos / [CLS], "jump", eos / [SEP]


def test_missing_transformers_and_files_are_named(model_dirs, tmp_path, monkeypatch):
    (tmp_path / "clip-empty").mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        ClipTextEncoder(str(tmp_path / "clip-empty"))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ClipTextEncoder(model_dirs["clip"])
    assert JTextEncoder(model_dirs["clip"]).is_fallback  # the JAX encoder falls back silently
