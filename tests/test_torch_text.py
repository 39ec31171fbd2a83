"""The port's text frontend against the JAX package's: exact equality.

Both are numpy/stdlib code over the same lexicon and the same two model
files, so nothing is approximate: normalisation, every G2p stage and the
token ids must be equal.  The two LTS tables and the lexicon are the
repository's one copy: the port opens them by path where they lie and
imports nothing of the JAX package for it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import tacotron2_tpu.text as jt
import tacotron2_torch.text as pt
from tacotron2_tpu.text import homographs as jh
from tacotron2_tpu.text import lexicon as jlex
from tacotron2_tpu.text import lts_model as jlm
from tacotron2_tpu.text import lts_neural as jln
from tacotron2_torch.config import SYMBOLS
from tacotron2_torch.text import homographs as ph
from tacotron2_torch.text import lexicon as plex
from tacotron2_torch.text import lts_model as plm
from tacotron2_torch.text import lts_neural as pln

# the sentences chip_smoke.py speaks, with the ids pinned there
SMOKE = {
    "The quick brown fox.": [
        21, 6, 69, 41, 65, 35, 41, 69, 18, 53, 13, 44, 69, 31, 1, 41, 54],
    "Speech synthesis on one card.": [
        54, 52, 38, 19, 69, 54, 35, 44, 57, 6, 54, 6, 54, 69, 1, 44, 69, 65,
        7, 44, 69, 41, 1, 53, 20],
    "It costs 42 dollars.": [
        35, 56, 69, 41, 1, 54, 56, 54, 69, 31, 10, 53, 56, 37, 69, 56, 62, 69,
        20, 1, 42, 25, 67],
    "A zorblaxian wug sings.": [
        6, 69, 67, 11, 53, 18, 42, 4, 41, 54, 37, 6, 44, 69, 65, 7, 32, 69,
        54, 35, 45, 67],
}

SENTENCES = list(SMOKE) + [
    "Hello world, this is a test.",
    "In 1984, they're sure it didn't cost $3,000,000 -- or 17 cents!",
    "She texted and tweeted; he googled the selfies.",
    "Smartphones, hashtags and podcasting: batchnorms overfitted.",
    "I read the book yesterday; you will read it. The lead pipe will lead.",
    "They record a record, and the wind will wind down.",
    "The naïve über-wug met a pneumonoultramicroscopicsilicovolcanoconiosisification.",
    "Dr. O'Neil's dog can't won't shouldn't've.",
    "",
    "   ...   ",
    "1 22 333 4444 55555 1000000 007",
]

# word -> the stage that resolves it, with the trained LTS models on / off
STAGES = [
    ("hello", "lexicon", "lexicon"),
    ("dont", "apostrophe", "apostrophe"),
    ("theyre", "apostrophe", "apostrophe"),
    ("texted", "morphology", "morphology"),
    ("tweeted", "morphology", "morphology"),
    ("zorblaxian", "lts_model", "lts_rules"),          # neural LTS
    ("pneumonoultramicroscopicsilicovolcanoconiosisification", "lts_model",
     "lts_rules"),                                      # past the neural cap:
                                                        # the n-gram LTS
    ("smartphones", "lts_model", "compound"),
    ("hashtags", "lts_model", "compound"),
    ("naïve", "lts_rules", "lts_rules"),
    ("selfies", "lts_model", "lts_rules"),
]


@pytest.fixture(scope="module")
def g2ps():
    return {(side, lts): mod.G2p(lts_model=lts)
            for side, mod in (("jax", jt), ("port", pt))
            for lts in (True, False)}


@pytest.mark.parametrize("port_mod,jax_mod", [(pln, jln), (plm, jlm)],
                         ids=["lts_neural.npz", "lts_ngram.npz"])
def test_model_files_are_the_originals(port_mod, jax_mod):
    """The port's default paths exist and are the JAX package's own files,
    not copies."""
    assert os.path.isfile(port_mod.DEFAULT_MODEL_PATH)
    assert os.path.samefile(port_mod.DEFAULT_MODEL_PATH,
                            jax_mod.DEFAULT_MODEL_PATH)
    assert not os.path.exists(os.path.join(os.path.dirname(pt.__file__),
                                           "data"))


def test_text_frontend_imports_nothing_of_the_jax_package():
    """A fresh interpreter that imports the port's text frontend and runs
    it (lexicon and both tables loaded) holds no ``tacotron2_tpu`` or
    ``jax`` module."""
    code = (
        "import sys\n"
        "import tacotron2_torch.text as t\n"
        "from tacotron2_torch.text import lts_model, lts_neural\n"
        "assert t.text_to_sequence('A zorblaxian wug.')\n"
        "assert lts_model.load_default_model() is not None\n"
        "assert lts_neural.load_default_model() is not None\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('tacotron2_tpu', 'jax', 'jaxlib')]\n"
        "assert not bad, bad\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_lexicon_is_the_shared_file():
    assert plex.find_lexicon_path() == jlex.find_lexicon_path()
    assert plex.find_lexicon_path().endswith(
        os.path.join("third_party", "cmudict", "cmudict.gz"))
    assert plex.load_lexicon() == jlex.load_lexicon()


@pytest.mark.parametrize("text", SENTENCES)
def test_normalize_text(text):
    assert pt.normalize_text(text) == jt.normalize_text(text)


@pytest.mark.parametrize("n", [0, 7, 13, 42, 100, 1984, 3000000, 10 ** 9 + 1,
                               "007"])
def test_number_to_words(n):
    assert pt.number_to_words(n) == jt.number_to_words(n)


@pytest.mark.parametrize("word,with_lts,without_lts", STAGES)
def test_g2p_stage(g2ps, word, with_lts, without_lts):
    """Every resolver is reached by some word, and gives the JAX package's
    phonemes."""
    for lts, stage in ((True, with_lts), (False, without_lts)):
        port, ref = g2ps["port", lts], g2ps["jax", lts]
        assert port.resolution(word) == ref.resolution(word) == stage
        assert tuple(port.pronounce(word)) == tuple(ref.pronounce(word))


def test_stages_cover_every_resolver():
    assert ({s for _, a, b in STAGES for s in (a, b)}
            == {"lexicon", "apostrophe", "morphology", "lts_model",
                "compound", "lts_rules"})


def test_both_trained_lts_models_answer(g2ps):
    """The neural model answers a short OOV word; past its length cap it
    gives none and the n-gram model answers, on both sides alike."""
    short, long_ = STAGES[5][0], STAGES[6][0]
    for mod_n, mod_g in ((pln, plm), (jln, jlm)):
        neural, ngram = mod_n.load_default_model(), mod_g.load_default_model()
        assert neural.pronounce(short) and neural.pronounce(long_) is None
        assert ngram.pronounce(long_)
    assert (pln.load_default_model().pronounce(short)
            == jln.load_default_model().pronounce(short))
    assert (plm.load_default_model().pronounce(long_)
            == jlm.load_default_model().pronounce(long_))
    assert (pt.letter_to_sound("zorblaxian")
            == jt.letter_to_sound("zorblaxian"))


@pytest.mark.parametrize("word,prev", [("read", "have"), ("read", "will"),
                                       ("lead", "the"), ("wind", "to"),
                                       ("record", "a"), ("live", None)])
def test_homographs(word, prev):
    assert ph.disambiguate(word, prev) == jh.disambiguate(word, prev)


@pytest.mark.parametrize("lts", [True, False])
@pytest.mark.parametrize("text", SENTENCES)
def test_text_to_sequence(g2ps, text, lts):
    ref = jt.text_to_sequence(text, g2ps["jax", lts])
    got = pt.text_to_sequence(text, g2ps["port", lts])
    assert got == ref
    assert pt.sequence_to_text(got) == jt.sequence_to_text(ref)
    assert all(0 <= i < len(SYMBOLS) for i in got)


@pytest.mark.parametrize("text", list(SMOKE))
def test_smoke_sentences_pinned_ids(text):
    assert pt.text_to_sequence(text) == SMOKE[text]
    assert jt.text_to_sequence(text) == SMOKE[text]


def test_texts_to_batch():
    texts = SENTENCES[:6]
    ref_tok, ref_len = jt.texts_to_batch(texts, pad_multiple=16)
    tok, lens = pt.texts_to_batch(texts, pad_multiple=16)
    assert tok.dtype == np.int32 and tok.shape[1] % 16 == 0
    np.testing.assert_array_equal(tok, ref_tok)
    np.testing.assert_array_equal(lens, ref_len)
    with pytest.raises(ValueError, match="pad_to"):
        pt.texts_to_batch(texts, pad_to=3)


def test_no_environment_switches(monkeypatch):
    """The JAX package's kill-switches do nothing to the port:
    ``G2p(lts_model=False)`` is its way to run without the models."""
    monkeypatch.setenv("TACOTRON2_LTS_MODEL", "0")
    monkeypatch.setenv("TACOTRON2_LTS_NEURAL", "0")
    plm.load_default_model.cache_clear()
    pln.load_default_model.cache_clear()
    try:
        assert plm.load_default_model() is not None
        assert pln.load_default_model() is not None
        assert pt.G2p().resolution("zorblaxian") == "lts_model"
    finally:
        plm.load_default_model.cache_clear()
        pln.load_default_model.cache_clear()
    assert pt.G2p(lts_model=False).resolution("zorblaxian") == "lts_rules"
