"""The port's quality scorers (``eval/bleu.py``, ``eval/bleu_native.py``,
``eval/quality.py``) against sacrebleu 2.6.0 and the JAX package's scorers.

- Corpus BLEU against ``sacrebleu.corpus_bleu`` at its defaults (13a, exp,
  no lowercasing) to 1e-9, over ``hypothesis``-drawn corpora of one or two
  reference streams: empty hypotheses and references, punctuation, the HTML
  entities 13a unescapes, digits with separators, non-ASCII letters.
- ``SacreBLEUScorer``, ``ASRBLEUScorer`` (a fixed ``asr_fn``; none: NaN) and
  ``WERScorer`` against JAX's on the same instances.
- ``remove_simuleval_silence`` against JAX's on seeded arrays with zero runs
  of 1-20 samples, runs at both ends included (the wrap-around).
- ``BleuScorer`` and ``batched_edit_distance``: the native library, the
  plain version and JAX's, all equal; both libraries are built into
  ``build/native/`` and nothing new appears under ``native/``.
No model runs here.
"""

import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import sacrebleu
from hypothesis import given, settings
from hypothesis import strategies as st
from streamspeech_tpu.eval import bleu_native as jax_bleu_native
from streamspeech_tpu.eval import quality as jax_quality

from streamspeech_tpu_torch import native
from streamspeech_tpu_torch.eval import bleu_native, quality
from streamspeech_tpu_torch.eval.bleu import corpus_bleu, tokenize_13a
from streamspeech_tpu_torch.eval.evaluator import build_quality_scorers

REPO = Path(__file__).resolve().parents[1]

PIECES = ["the", "cat", "Cat", "a", "é", "über", "naïve", "日本", "ß", ".", ",", "!", "?",
          "-", "--", "'s", '"', "(", ")", "[x]", "{y}", "&amp;", "&quot;", "&lt;",
          "&gt;", "&", "<skipped>", "1,000", "3.14", "2-3", "10.5%", "$5", "e.g.",
          "U.S.", " ", "\t", "x-\ny", "\n"]
segment = st.lists(st.sampled_from(PIECES), max_size=14).map(" ".join) | st.just("")


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 6).flatmap(lambda n: st.tuples(
    st.lists(segment, min_size=n, max_size=n),
    st.lists(st.lists(segment, min_size=n, max_size=n), min_size=1, max_size=2))))
def test_corpus_bleu_matches_sacrebleu(corpus):
    hyps, refs = corpus
    want = sacrebleu.corpus_bleu(hyps, refs).score
    assert abs(corpus_bleu(hyps, refs) - want) <= 1e-9 * max(1.0, abs(want))


def test_corpus_bleu_fixed_cases():
    cases = [(["the cat sat on the mat ."], [["the cat sat on the mat ."]]),
             (["the cat"], [["the cat sat on the mat"]]),
             ([""], [["a b c"]]),
             (["1,000.5 dollars &amp; cents -- 2-3"], [["1,000.5 dollars & cents -- 2 - 3"]]),
             (["x y z w", "a b"], [["x y z w", "a b c"], ["x y", "a"]])]
    for hyps, refs in cases:
        assert corpus_bleu(hyps, refs) == sacrebleu.corpus_bleu(hyps, refs).score
    tok = sacrebleu.metrics.bleu._get_tokenizer("13a")()
    for line in ["Hello, world!", "3.14-2", "a&quot;b&gt;c", "don't -- stop.", ""]:
        assert tokenize_13a(line) == tok(line)
    with pytest.raises(ValueError):
        corpus_bleu([], [[]])


def _text_instances(rng, n=6):
    words = ["w%d" % i for i in range(8)] + ["Hello,", "World.", "&amp;"]
    out = {}
    for i in range(n):
        pred = " ".join(rng.choice(words, rng.randint(0, 9)))
        ref = None if i == 3 else " ".join(rng.choice(words, rng.randint(1, 9)))
        out[i] = SimpleNamespace(prediction=pred, reference=ref)
    return out


def _speech_instances(rng, n=4):
    out = {}
    for i in range(n):
        wav = rng.randn(rng.randint(50, 400)).astype(np.float32)
        wav[rng.randint(0, len(wav) - 20): ][:15] = 0.0
        out[i] = SimpleNamespace(stitched=None if i == 2 else wav, target_sample_rate=16000,
                                 reference=f"W{i} w{i + 1} hello")
    return out


def _asr_fn(wav, sample_rate=16000):
    """A fixed backend: words from the length and the zeros of the wav."""
    w = np.asarray(wav)
    return f"w{len(w) % 5} W{int((w == 0).sum()) % 3} Hello w{sample_rate // 8000}"


def test_scorers_match_jax():
    rng = np.random.RandomState(0)
    text = _text_instances(rng)
    assert quality.SacreBLEUScorer()(text) == jax_quality.SacreBLEUScorer()(text)
    assert quality.WERScorer()(text) == jax_quality.WERScorer()(text)
    speech = _speech_instances(rng)
    got, want = quality.ASRBLEUScorer(_asr_fn), jax_quality.ASRBLEUScorer(_asr_fn)
    assert got.transcripts(speech) == want.transcripts(speech)
    assert got(speech) == want(speech)
    assert math.isnan(quality.ASRBLEUScorer()(speech))
    scorers = build_quality_scorers(["BLEU", "WER", "ASR_BLEU"])
    assert [type(s) for s in scorers.values()] == [quality.SacreBLEUScorer,
                                                   quality.WERScorer, quality.ASRBLEUScorer]


@pytest.mark.parametrize("seed", range(6))
def test_remove_simuleval_silence_matches_jax(seed):
    rng = np.random.RandomState(seed)
    wav = rng.randn(600).astype(np.float32)
    pos = 0
    while pos < len(wav):
        run = rng.randint(1, 21)
        wav[pos:pos + run] = 0.0
        pos += run + rng.randint(1, 40)
    # runs at both ends, which the roll wraps into one
    wav[:rng.randint(1, 21)] = 0.0
    wav[len(wav) - rng.randint(1, 21):] = 0.0
    got = quality.remove_simuleval_silence(wav)
    np.testing.assert_array_equal(got, jax_quality.remove_simuleval_silence(wav))
    assert got.size < wav.size
    assert quality.remove_simuleval_silence(np.zeros(0)).size == 0


def test_native_libraries_match_plain_and_jax():
    before = sorted(p.name for p in (REPO / "native").iterdir())
    rng = np.random.RandomState(0)
    pairs = [(rng.randint(0, 30, rng.randint(0, 20)).tolist(),
              rng.randint(0, 30, rng.randint(0, 20)).tolist()) for _ in range(25)]
    pairs += [([1, 2, 3, 4, 5], [1, 2, 3, 4, 5]), ([], [7]), ([3, 3, 3, 3], [3, 3])]
    lib, plain, ref = bleu_native.BleuScorer(), bleu_native.BleuScorer(), \
        jax_bleu_native.BleuScorer()
    ref._lib = None                     # JAX's Python counter
    for r, h in pairs:
        lib.add(r, h)
        plain.add_plain(r, h)
        ref._add_py(r, h)
    np.testing.assert_array_equal(lib.counts, plain.counts)
    np.testing.assert_array_equal(lib.counts, ref.counts)
    assert lib.score() == plain.score() == ref.score()

    words = [(["w%d" % x for x in a], ["w%d" % x for x in b]) for a, b in pairs]
    words += [([], []), (["x"], []), (["ü", "b"], ["b", "ü"])]
    got = quality.batched_edit_distance(words)
    assert got == [quality.edit_distance_plain(a, b) for a, b in words]
    assert got == jax_quality.batched_edit_distance(words)
    assert quality.batched_edit_distance([]) == []
    for source in ("bleu", "edit_dist"):
        assert native.library_path(source).parent == REPO / "build" / "native"
        assert native.library_path(source).exists()
    jax_made = {"libbleu.so", "libeditdist.so"}    # the JAX package builds into native/
    after = sorted(p.name for p in (REPO / "native").iterdir())
    assert set(after) - set(before) <= jax_made


def test_native_build_failure_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.load("broken")
    assert not (tmp_path / "build" / "libbroken.so").exists()


def test_whisper_asr_bleu_raises_and_says_why():
    with pytest.raises(NotImplementedError, match="Whisper weights"):
        build_quality_scorers(["WHISPER_ASR_BLEU"])
    with pytest.raises(KeyError):
        build_quality_scorers(["NO_SUCH_SCORER"])
