"""The port's training data path against the JAX package's, on the CPU.

- ``config.load_yaml`` equals ``yaml.safe_load`` on the toy task's configs and
  on a data config with global CMVN, SpecAugment, transforms and a vocoder;
  it raises on anchors, aliases, tags, multi-line strings and flow mappings.
  ``S2SDataConfig.load`` and ``MultitaskConfig.load`` give JAX's configs.
- The native batcher (``native/batcher.cpp`` built into ``build/native/``)
  equals the plain version and JAX's ``batch_by_size``; a failed build raises.
- ``SpeechToSpeechDataset.batches`` gives JAX's index lists for the same
  seeds, and ``collate`` JAX's arrays, at ``n_frames_per_step`` 1 and 2, on a
  toy task on disk: the train split's stored fbank exactly, the dev split's
  fbank computed from the wavs within an fbank tolerance (``FBANK``: two FFT
  libraries).
- ``generate_toy_dataset`` writes JAX's files: the same manifests, targets,
  dictionaries, configs and wavs, and fbank within that tolerance.
- ``utils.metrics`` and ``utils.tensorboard`` log what JAX's log.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import yaml

from streamspeech_tpu import config as jconfig
from streamspeech_tpu.data import batching as jbatching
from streamspeech_tpu.data import dataset as jdataset
from streamspeech_tpu.data import toy_task as jtoy
from streamspeech_tpu.dictionary import Dictionary as JaxDictionary
from streamspeech_tpu.utils import metrics as jmetrics
from streamspeech_tpu.utils import tensorboard as jtb

from streamspeech_tpu_torch import config as pconfig
from streamspeech_tpu_torch import native
from streamspeech_tpu_torch.data import batching as pbatching
from streamspeech_tpu_torch.data import dataset as pdataset
from streamspeech_tpu_torch.data import toy_task as ptoy
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.utils import metrics as pmetrics
from streamspeech_tpu_torch.utils import tensorboard as ptb
from tests.torch_threads import one_torch_thread  # noqa: F401

# log-mel values of order 10: ``tests/test_torch_layers.py`` holds the two
# fbanks to rtol 1e-4, atol 2e-4 on a tone in noise; the toy task's tones over
# 1/100 as much noise leave mel bins 1e-4 of the frame's peak power, where the
# two libraries' fp32 FFT rounding reaches 1.3e-3 (6 of 20480 values)
FBANK = dict(rtol=1e-4, atol=2e-3)

DATA_CONFIG = """\
# config_gcmvn.yaml of the reference recipe, with a vocoder section
input_channels: 1
input_feat_per_channel: 80
global_cmvn:
  stats_npz_path: gcmvn.npz
specaugment:
  freq_mask_F: 27
  freq_mask_N: 1
  time_mask_N: 1
  time_mask_T: 100
  time_mask_p: 1.0
  time_wrap_W: 0
transforms:
  '*':
  - global_cmvn
  _train:
  - global_cmvn
  - specaugment
vocoder:
  type: code_hifigan
  config: "vocoder/config.json"   # resolved to the yaml's directory by name
  checkpoint: vocoder/g_00500000
flags: [true, no, ~, 1e-3, 1.0e-3, .5, -2., 'quoted # not a comment', "tab\\tx"]
nested:
  - name: a
    values: [1, 2]
  -
    - 3
empty:
"""
UNSUPPORTED = ["a: &x 1\nb: *x", "a: |\n  text\n", "a: >\n  folded\n", "a: !!str 1",
               "a: {x: 1}", "--- \na: 1", "a: 0x1f", "a: b\n  c\n"]


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    return ptoy.generate_toy_dataset(str(root / "data"), n_train=24, n_dev=8, seed=5,
                                     samples_per_word=1600)


def test_yaml_reader_equals_safe_load(toy, tmp_path):
    docs = [DATA_CONFIG] + [(p := f"{toy['data']}/{name}") and open(p).read()
                            for name in (toy["config_yaml"], toy["multitask_config_yaml"])]
    for doc in docs:
        assert pconfig.load_yaml(doc) == yaml.safe_load(doc)
    assert pconfig.load_yaml("") is None and yaml.safe_load("") is None
    for doc in UNSUPPORTED:
        with pytest.raises(pconfig.YamlSubsetError):
            pconfig.load_yaml(doc)


def test_data_configs_equal_jaxs(toy, tmp_path):
    (tmp_path / "config.json").write_text("{}")
    (tmp_path / "config.yaml").write_text(DATA_CONFIG)
    got = pconfig.S2SDataConfig.load(str(tmp_path / "config.yaml"))
    want = jconfig.S2SDataConfig.load(str(tmp_path / "config.yaml"))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vocoder_config == str(tmp_path / "config.json")
    for split in ("train", "dev"):
        assert got.get_transforms(split) == want.get_transforms(split)
    path = f"{toy['data']}/{toy['multitask_config_yaml']}"
    assert dataclasses.asdict(pconfig.MultitaskConfig.load(path)) == \
        dataclasses.asdict(jconfig.MultitaskConfig.load(path))


@pytest.mark.parametrize("seed", range(4))
def test_native_batcher_equals_the_plain_version_and_jax(seed):
    rng = np.random.RandomState(seed)
    n = int(rng.randint(1, 300))
    num_tokens = rng.randint(1, 400, size=n)
    order = np.argsort(num_tokens, kind="stable") if seed % 2 else rng.permutation(n)
    for max_tokens, max_sentences, mult in ((1000, 0, 8), (0, 7, 8), (3000, 16, 4),
                                            (150, 0, 1), (50, 3, 8)):
        got = pbatching.batch_by_size(order, num_tokens, max_tokens, max_sentences, mult)
        plain = pbatching._batch_by_size_py(order, num_tokens, max_tokens,
                                            max_sentences, mult)
        want = jbatching.batch_by_size(order, num_tokens, max_tokens, max_sentences, mult)
        assert [b.tolist() for b in got] == [b.tolist() for b in plain] == \
            [b.tolist() for b in want]
        assert sorted(np.concatenate(got).tolist()) == sorted(order.tolist())
    assert pbatching.batch_by_size(np.zeros(0), num_tokens) == []


def test_failed_native_build_raises(monkeypatch, tmp_path):
    (tmp_path / "batcher.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match="failed"):
        pbatching.batch_by_size(np.arange(4), np.ones(4, np.int64), 10)


def _datasets(toy, split, nfps):
    """The port's and JAX's dataset of one split over the same files."""
    out = []
    for cfg_mod, ds_mod, dict_cls in ((pconfig, pdataset, Dictionary),
                                      (jconfig, jdataset, JaxDictionary)):
        units = dict_cls.units(toy["n_units"])
        units.add_blank()
        mt = cfg_mod.MultitaskConfig.load(f"{toy['data']}/{toy['multitask_config_yaml']}")
        targets = {name: ds_mod.SpeechToSpeechDataset.load_multitask_targets(
            f"{toy['data']}/{name}/{split}.tsv", dict_cls.load(task.dict_path))
            for name, task in mt.tasks.items()}
        out.append(ds_mod.SpeechToSpeechDataset(
            f"{toy['data']}/{split}.tsv", units,
            cfg_mod.S2SDataConfig.load(f"{toy['data']}/{toy['config_yaml']}"), targets,
            split=split, n_frames_per_step=nfps))
    return out


@pytest.mark.parametrize("nfps", [1, 2])
def test_batches_and_collate_equal_jaxs(toy, nfps):
    for split in ("train", "dev"):
        pds, jds = _datasets(toy, split, nfps)
        assert len(pds) == len(jds) > 0
        for seed in (None, 1, 7):
            for max_tokens, max_sentences in ((300, 0), (0, 5)):
                got = pds.batches(max_tokens, max_sentences, shuffle_seed=seed)
                want = jds.batches(max_tokens, max_sentences, shuffle_seed=seed)
                assert [b.tolist() for b in got] == [b.tolist() for b in want]
        for idx in got:
            pb, jb = pds.collate(idx), jds.collate(idx)
            assert sorted(pb) == sorted(jb)
            assert ("prev_output_tokens_unit" in pb) == (nfps > 1)
            for key, want in jb.items():
                assert pb[key].shape == want.shape and pb[key].dtype == want.dtype, key
                if key == "src_tokens" and split == "dev":
                    np.testing.assert_allclose(pb[key], want, **FBANK)
                else:
                    np.testing.assert_array_equal(pb[key], want, err_msg=key)


def test_toy_dataset_equals_jaxs(tmp_path):
    got = ptoy.generate_toy_dataset(str(tmp_path / "port"), n_train=3, n_dev=2, seed=2,
                                    samples_per_word=1600)
    want = jtoy.generate_toy_dataset(str(tmp_path / "jax"), n_train=3, n_dev=2, seed=2,
                                     samples_per_word=1600)
    assert {k: str(v).replace("/port", "") for k, v in got.items()} == \
        {k: str(v).replace("/jax", "") for k, v in want.items()}
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*") if p.is_file())
    for rel in files:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        if rel.suffix == ".npy":
            np.testing.assert_allclose(np.load(a), np.load(b), **FBANK)
        else:
            assert a.read_bytes().replace(b"/port", b"") == \
                b.read_bytes().replace(b"/jax", b""), rel
    assert ptoy.read_dev_refs(got["data"]) == jtoy.read_dev_refs(want["data"])
    hyp_units = [[1, 2, 3], [4]]
    hyp_text = [["w1"], ["w2", "w0"]]
    refs = jtoy.read_dev_refs(want["data"])
    assert ptoy.score_outputs(hyp_units, hyp_text, refs) == \
        jtoy.score_outputs(hyp_units, hyp_text, refs)


def test_progress_and_tensorboard_log_what_jaxs_log(tmp_path):
    lines = {}
    for name, mod, tb in (("port", pmetrics, ptb), ("jax", jmetrics, jtb)):
        agg = mod.MetricsAggregator()
        for v in (1.0, float("nan"), 3.25):
            agg.log_scalar("loss", v)
        with agg.aggregate("valid"):
            agg.log_scalar("loss", 7.0, weight=2.0)
        stream = io.StringIO()
        prog = mod.JsonProgress(log_file=str(tmp_path / f"{name}.log"), stream=stream,
                                tensorboard_logdir=str(tmp_path / f"tb_{name}"))
        prog.log(agg.get_smoothed_values("default"), tag="train", step=3)
        prog.log(agg.get_smoothed_values("valid"), tag="valid", step=3)
        events = sorted((tmp_path / f"tb_{name}").iterdir())
        lines[name] = (stream.getvalue(), (tmp_path / f"{name}.log").read_text(),
                       jtb.read_scalars(str(events[0])), ptb.read_scalars(str(events[0])))
    assert lines["port"] == lines["jax"]
    assert json.loads(lines["port"][0].splitlines()[0])["loss"] == (1 + 3.25 + 2 * 7) / 4
    assert ptb.crc32c(b"123456789") == jtb.crc32c(b"123456789") == 0xE3069283
