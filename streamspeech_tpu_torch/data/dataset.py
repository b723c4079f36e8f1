"""Speech-to-speech dataset: tsv manifests, multitask targets and collation
(the port of ``streamspeech_tpu/data/dataset.py``).

Behavioral reference: `fairseq/fairseq/data/audio/speech_to_speech_dataset.py:36-352`
and the modified variant `researches/ctc_unity/datasets/speech_to_speech_dataset_modified.py:28-224`.

Manifest tsv columns (tab-separated): id, src_audio, src_n_frames, tgt_audio,
tgt_n_frames — with --target-is-code, tgt_audio is the space-separated unit
sequence. Multitask targets live in per-task tsvs (id \t tgt_text) with text
already SPM-tokenized (the preprocess pipeline writes pieces).

Audio refs: "path.npy" | "archive.zip:offset:size" (fairseq zip packing) | ".wav".
Feature transforms (global CMVN; SpecAugment is applied in the train step)
follow `data_cfg.py:35` split semantics. Everything here is host NumPy: a
batch is a dict of arrays that the caller moves to the device.
"""

from __future__ import annotations

import io
import wave
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from streamspeech_tpu_torch.config import S2SDataConfig
from streamspeech_tpu_torch.data.batching import batch_by_size
from streamspeech_tpu_torch.dictionary import Dictionary

PAD, EOS = 1, 2


def load_audio_or_features(ref: str, root: Optional[Path] = None) -> np.ndarray:
    """A reference → a waveform (float32 in [-1, 1)) or a [T, 80] feature
    array: ``path.wav`` (16-bit PCM through ``wave``), ``path.npy``, or
    ``archive.zip:offset:size`` (fairseq's zip packing of .npy blobs). A
    relative path is taken under ``root``."""
    if ":" in ref and not Path(ref).exists():
        parts = ref.rsplit(":", 2)
        if len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
            zip_path, offset, size = Path(parts[0]), int(parts[1]), int(parts[2])
            if root is not None and not zip_path.is_absolute():
                zip_path = root / zip_path
            with open(zip_path, "rb") as f:
                f.seek(offset)
                data = f.read(size)
            return np.load(io.BytesIO(data), allow_pickle=False)
    p = Path(ref)
    if root is not None and not p.is_absolute():
        p = root / p
    if p.suffix == ".npy":
        return np.load(p, allow_pickle=False)
    if p.suffix == ".wav":
        with wave.open(str(p), "rb") as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
        return pcm.astype(np.float32) / 32768.0
    raise ValueError(f"unsupported audio reference: {ref}")


@dataclass
class S2SItem:
    index: int
    utt_id: str
    audio_ref: str
    n_frames: int
    units: List[int]
    mt_text: List[int] = field(default_factory=list)
    src_text: List[int] = field(default_factory=list)
    tgt_text: List[int] = field(default_factory=list)


class SpeechToSpeechDataset:
    def __init__(
        self,
        manifest_path: str,
        unit_dict: Dictionary,
        data_cfg: Optional[S2SDataConfig] = None,
        multitask_targets: Optional[Dict[str, Dict[str, List[int]]]] = None,
        split: str = "train",
        is_features: bool = True,
        n_frames_per_step: int = 1,
    ):
        self.root = Path(manifest_path).parent
        self.unit_dict = unit_dict
        self.data_cfg = data_cfg
        self.split = split
        self.is_features = is_features
        self.n_frames_per_step = n_frames_per_step
        self.gcmvn = None
        if data_cfg is not None and data_cfg.global_cmvn_stats_npz and \
                "global_cmvn" in data_cfg.get_transforms(split):
            stats = np.load(data_cfg.global_cmvn_stats_npz)
            self.gcmvn = (stats["mean"].astype(np.float32),
                          stats["std"].astype(np.float32))
        mt = multitask_targets or {}
        self.items: List[S2SItem] = []
        with open(manifest_path, "r", encoding="utf-8") as f:
            header = f.readline().rstrip("\n").split("\t")
            col = {name: i for i, name in enumerate(header)}
            for line in f:
                row = line.rstrip("\n").split("\t")
                if len(row) < len(col):
                    continue
                utt_id = row[col["id"]]
                units = [unit_dict.index(u)
                         for u in row[col["tgt_audio"]].split()] + [EOS]
                self.items.append(S2SItem(
                    index=len(self.items), utt_id=utt_id,
                    audio_ref=row[col["src_audio"]],
                    n_frames=int(row[col["src_n_frames"]]),
                    units=units,
                    mt_text=mt.get("target_unigram", {}).get(utt_id, []),
                    src_text=mt.get("source_unigram", {}).get(utt_id, []),
                    tgt_text=mt.get("ctc_target_unigram", {}).get(utt_id, []),
                ))

    def _pack_units(self, units_with_eos: List[int]) -> List[int]:
        """Stack n_frames_per_step consecutive unit ids into one packed id
        (`fairseq/fairseq/data/audio/speech_to_speech_dataset.py:88-104`):
        the trailing EOS is kept unpacked; each group packs first-unit-most-
        significant with offset 4 and V = len(dict) - 4. Packed ids feed ONLY
        the AR decoder input (`prev_output_tokens_unit`, reference
        `_collate_target` :164-171); the CTC/CE TARGET stays RAW (:156-162).
        The reference requires the unit count to divide n; real unit streams
        don't, so the tail group is right-padded by repeating the last unit,
        as the JAX package does."""
        n = self.n_frames_per_step
        v = len(self.unit_dict) - 4
        raw = np.asarray(units_with_eos[:-1], np.int64) - 4
        rem = (-len(raw)) % n
        if rem and len(raw):
            raw = np.concatenate([raw, np.repeat(raw[-1:], rem)])
        scale = v ** np.arange(n - 1, -1, -1, dtype=np.int64)
        packed = (raw.reshape(-1, n) * scale).sum(axis=1) + 4
        return [int(p) for p in packed] + [units_with_eos[-1]]

    @classmethod
    def load_multitask_targets(cls, tsv_path: str, dictionary: Dictionary
                               ) -> Dict[str, List[int]]:
        out = {}
        with open(tsv_path, "r", encoding="utf-8") as f:
            header = f.readline().rstrip("\n").split("\t")
            col = {name: i for i, name in enumerate(header)}
            for line in f:
                row = line.rstrip("\n").split("\t")
                if len(row) < 2:
                    continue
                out[row[col["id"]]] = dictionary.encode_line(
                    row[col["tgt_text"]], append_eos=False)
        return out

    def __len__(self):
        return len(self.items)

    def num_tokens(self) -> np.ndarray:
        return np.asarray([it.n_frames for it in self.items], dtype=np.int64)

    def features(self, item: S2SItem) -> np.ndarray:
        x = load_audio_or_features(item.audio_ref, self.root)
        if x.ndim == 1:  # waveform → fbank on the fly
            from streamspeech_tpu_torch.ops.fbank import logmelfbank
            x = np.asarray(logmelfbank(x))
        if self.gcmvn is not None:
            x = (x - self.gcmvn[0]) / self.gcmvn[1]
        return x.astype(np.float32)

    def batches(self, max_tokens: int = 0, max_sentences: int = 0,
                bsz_mult: int = 8, shuffle_seed: Optional[int] = None
                ) -> List[np.ndarray]:
        """Length-bucketed index lists. With ``shuffle_seed`` the same
        ``np.random.RandomState`` calls as the JAX package, in its order: a
        permutation as the sort's tie-break noise, then a shuffle of the
        batches."""
        n_tok = self.num_tokens()
        order = np.argsort(n_tok, kind="stable")
        if shuffle_seed is not None:
            rng = np.random.RandomState(shuffle_seed)
            # shuffle then length-sort (fairseq's noisy ordering)
            noise = rng.permutation(len(order))
            order = np.lexsort((noise, n_tok))
        batches = batch_by_size(order, n_tok, max_tokens, max_sentences, bsz_mult)
        if shuffle_seed is not None:
            rng.shuffle(batches)
        return batches

    def collate(self, indices: np.ndarray, frame_mult: int = 32) -> Dict[str, np.ndarray]:
        """Pad a batch; frame lengths rounded up to frame_mult (keeps the conv
        chunk layout aligned and caps the number of distinct shapes)."""
        items = [self.items[i] for i in indices]
        feats = [self.features(it) for it in items]
        t_max = max(f.shape[0] for f in feats)
        t_max = -(-t_max // frame_mult) * frame_mult
        b = len(items)
        src = np.zeros((b, t_max, feats[0].shape[1]), np.float32)
        src_len = np.zeros((b,), np.int32)
        for i, f in enumerate(feats):
            src[i, : f.shape[0]] = f
            src_len[i] = f.shape[0]

        def pad_tokens(seqs, prepend_eos=False):
            n = max(max((len(s) for s in seqs), default=1), 1) + int(prepend_eos)
            out = np.full((b, n), PAD, np.int32)
            lens = np.zeros((b,), np.int32)
            for i, s in enumerate(seqs):
                s = list(s)
                if prepend_eos:
                    s = [EOS] + s
                out[i, : len(s)] = s
                lens[i] = len(s)
            return out, lens

        units, unit_lens = pad_tokens([it.units for it in items])
        prev_units = None
        if self.n_frames_per_step > 1:
            # AR-decoder teacher input: packed stacked ids, EOS moved to the
            # beginning (reference `_collate_target`
            # speech_to_speech_dataset.py:164-171 collate_tokens(...,
            # move_eos_to_beginning=True)); the CTC target above stays raw
            prev_units, _ = pad_tokens(
                [[EOS] + self._pack_units(it.units)[:-1] for it in items])
        prev_mt, _ = pad_tokens([it.mt_text for it in items], prepend_eos=True)
        mt_tgt, _ = pad_tokens([it.mt_text + [EOS] for it in items])
        src_text, src_text_lens = pad_tokens([it.src_text for it in items])
        tgt_text, tgt_text_lens = pad_tokens([it.tgt_text for it in items])
        extra = ({} if prev_units is None
                 else {"prev_output_tokens_unit": prev_units})
        return {
            **extra,
            "id": np.asarray([it.index for it in items]),
            "src_tokens": src,
            "src_lengths": src_len,
            "prev_output_tokens_mt": prev_mt,
            "mt_targets": mt_tgt,
            "target_units": units,
            "target_unit_lengths": unit_lens,
            "src_text": src_text,
            "src_text_lengths": src_text_lens,
            "tgt_text": tgt_text,
            "tgt_text_lengths": tgt_text_lens,
        }
