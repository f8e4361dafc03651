"""The TM2T evaluator's modules against the JAX package on the CPU in f32:
the packed BiGRU on ragged lengths against the masked scan, the three
encoders, the word vectorizer (hashed and with GloVe files the test
writes), the evaluator's `embed_text` / `embed_motion`, its weights loaded
from a released-format file the test writes, and the converters both ways.
Weights go from the flax trees through `convert.py`; tolerance 1e-5 of the
output's max |.|.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from seeme_tpu.data.word_vectorizer import WordVectorizer as JWordVectorizer
from seeme_tpu.eval.t2m_evaluator import T2MEvaluator as JEvaluator
from seeme_tpu.nn import gru as jgru
from seeme_tpu_torch import convert
from seeme_tpu_torch.data.word_vectorizer import WordVectorizer
from seeme_tpu_torch.eval.t2m_evaluator import T2MEvaluator, evaluator_state_dicts
from seeme_tpu_torch.nn.gru import BiGru, MotionEncoderBiGRUCo, MovementConvEncoder, TextEncoderBiGRUCo
from tools.convert_checkpoint import (
    convert_t2m_motionencoder,
    convert_t2m_movementencoder,
    convert_t2m_textencoder,
)

RTOL = 1e-5
B, T = 4, 24
LENGTHS = np.array([24, 7, 1, 16])  # ragged, one a single step
WIDTHS = dict(word_size=300, pos_size=15, text_hidden=16, move_hidden=12, move_out=10,
              motion_hidden=14, output_size=8)


def rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()))


def loaded(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_bigru_ragged_lengths_match_the_masked_scan():
    """Each row's forward state at its own last frame and its backward pass
    from there: the packed `nn.GRU` against the JAX masked scan."""
    x, h0 = rand(1, B, T, 6), rand(2, 2, B, 5)
    jmod = jgru.BiGru(5)
    params = jmod.init(jax.random.PRNGKey(0), x, LENGTHS, h0)
    sd = {}
    convert._bigru(sd, "gru", params["params"])
    gru = loaded(BiGru(6, 5), {k[4:]: v for k, v in sd.items()})
    got = gru(torch.as_tensor(x), torch.as_tensor(LENGTHS), torch.as_tensor(h0))
    close(got.detach().numpy(), jmod.apply(params, x, LENGTHS, h0))
    # padding past a row's length does not reach its states
    x2 = x.copy()
    x2[1, 7:] = 100.0
    again = gru(torch.as_tensor(x2), torch.as_tensor(LENGTHS), torch.as_tensor(h0))
    torch.testing.assert_close(again[1], got[1], rtol=0, atol=0)


def test_text_encoder_matches_flax_and_converts_both_ways():
    words, pos = rand(3, B, 22, 20), rand(4, B, 22, 15)
    lens = np.array([22, 5, 2, 13])
    jmod = jgru.TextEncoderBiGRUCo(word_size=20, pos_size=15, hidden_size=16, output_size=8)
    params = jmod.init(jax.random.PRNGKey(1), words, pos, lens)
    sd = convert.t2m_text_state_dict(jax.tree.map(np.asarray, params))
    enc = loaded(TextEncoderBiGRUCo(20, 15, 16, 8), sd)
    got = enc(torch.as_tensor(words), torch.as_tensor(pos), torch.as_tensor(lens))
    close(got.detach().numpy(), jmod.apply(params, words, pos, lens))
    back = convert_t2m_textencoder({k: v.numpy() for k, v in sd.items()})
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, params))


def test_movement_and_motion_encoders_match_flax_and_convert_both_ways():
    feats = rand(5, B, T, 30)
    jmove = jgru.MovementConvEncoder(hidden_size=12, output_size=10)
    pmove = jmove.init(jax.random.PRNGKey(2), feats)
    sd = convert.t2m_movement_state_dict(jax.tree.map(np.asarray, pmove))
    move = loaded(MovementConvEncoder(30, 12, 10), sd)
    mov = move(torch.as_tensor(feats))
    assert mov.shape == (B, T // 4, 10)
    close(mov.detach().numpy(), jmove.apply(pmove, feats))
    back = convert_t2m_movementencoder({k: v.numpy() for k, v in sd.items()})
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, pmove))

    jmot = jgru.MotionEncoderBiGRUCo(input_size=10, hidden_size=14, output_size=8)
    x, m_lens = mov.detach().numpy(), np.array([6, 2, 1, 4])
    pmot = jmot.init(jax.random.PRNGKey(3), x, m_lens)
    sd = convert.t2m_motion_state_dict(jax.tree.map(np.asarray, pmot))
    mot = loaded(MotionEncoderBiGRUCo(10, 14, 8), sd)
    close(mot(torch.as_tensor(x), torch.as_tensor(m_lens)).detach().numpy(),
          jmot.apply(pmot, x, m_lens))
    back = convert_t2m_motionencoder({k: v.numpy() for k, v in sd.items()})
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, pmot))


TOKENS = ["sos/OTHER", "a/DET", "person/NOUN", "walks/VERB", "left/ADV", "walk/VERB",
          "zzzunknown/NOUN", "slowly/ADV", "eos/OTHER", "chair", "stair/NOUN"]


def write_glove(root):
    vocab = ["a", "person", "walks", "left", "walk", "slowly", "sos", "eos", "unk", "stair"]
    np.save(root / "our_vab_data.npy", rand(9, len(vocab), 300))
    with open(root / "our_vab_words.pkl", "wb") as f:
        pickle.dump(vocab, f)
    with open(root / "our_vab_idx.pkl", "wb") as f:
        pickle.dump({w: i for i, w in enumerate(vocab)}, f)


@pytest.mark.parametrize("glove", [False, True], ids=["hashed", "glove"])
def test_word_vectorizer_matches_jax(glove, tmp_path):
    """Word vectors and POS one-hots (VIP remaps, out-of-vocabulary words to
    `unk` and OTHER) and the padded sos/eos arrays."""
    if glove:
        write_glove(tmp_path)
    root = str(tmp_path) if glove else None
    ours, ref = WordVectorizer(root), JWordVectorizer(root)
    assert ours.is_fallback == ref.is_fallback == (not glove)
    for tok in TOKENS:
        for a, b in zip(ours[tok], ref[tok]):
            np.testing.assert_array_equal(a, b, err_msg=tok)
    for a, b in zip(ours.tokens_to_arrays(TOKENS[1:8] * 4, 20), ref.tokens_to_arrays(TOKENS[1:8] * 4, 20)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jevaluator():
    return JEvaluator(nfeats=30, **WIDTHS)


def evaluator_file(jev, path):
    """The JAX evaluator's weights in the released `finest.tar` layout."""
    sds = {"text_encoder": convert.t2m_text_state_dict(jax.tree.map(np.asarray, jev.text_params)),
           "movement_encoder": convert.t2m_movement_state_dict(
               jax.tree.map(np.asarray, jev.move_params)),
           "motion_encoder": convert.t2m_motion_state_dict(
               jax.tree.map(np.asarray, jev.motion_params))}
    torch.save({**sds, "epoch": 3}, path)
    return path


def test_evaluator_embeddings_match_jax(jevaluator, tmp_path):
    """`embed_text` and `embed_motion` (foot contacts dropped, lengths in
    units of 4) with the JAX evaluator's weights, loaded from a released-
    format file or the release's directory."""
    path = evaluator_file(jevaluator, tmp_path / "finest.tar")
    ours = T2MEvaluator(nfeats=30, ckpt=str(path), device="cpu", **WIDTHS)
    assert ours.is_pretrained and not T2MEvaluator(nfeats=30, device="cpu", **WIDTHS).is_pretrained
    texts = ["a/DET person/NOUN walks/VERB left/ADV", "jump", "the man turns around " * 8]
    close(ours.embed_text(texts), jevaluator.embed_text(texts))
    feats, lengths = rand(6, B, T, 30), np.array([24, 12, 16, 4])
    close(ours.embed_motion(feats, lengths), jevaluator.embed_motion(feats, lengths))
    (tmp_path / "flat" / "model").mkdir(parents=True)
    evaluator_file(jevaluator, tmp_path / "flat" / "model" / "finest.tar")
    flat = T2MEvaluator(nfeats=30, ckpt=str(tmp_path / "flat"), device="cpu", **WIDTHS)
    for k, v in ours.state_dict().items():
        torch.testing.assert_close(flat.state_dict()[k], v, rtol=0, atol=0)
    assert set(evaluator_state_dicts(str(path))) == {"text_encoder", "movement_encoder",
                                                     "motion_encoder"}
    with pytest.raises(FileNotFoundError):
        T2MEvaluator(nfeats=30, ckpt=str(tmp_path / "flat" / "model" / "absent"), device="cpu",
                     **WIDTHS)
    with pytest.raises(RuntimeError):  # a width that does not match the file
        T2MEvaluator(nfeats=30, ckpt=str(path), device="cpu", **{**WIDTHS, "text_hidden": 32})


def test_evaluator_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T2MEvaluator(**WIDTHS)
