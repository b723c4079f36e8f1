"""Batched corpus evaluation: B instances a wave through one lockstep session
(``streamspeech_tpu/eval/batched_evaluator.py``), for S2ST
(``BatchedS2STEvaluator``), S2TT (``BatchedS2TTEvaluator``) and streaming ASR
(``BatchedASREvaluator``).

The reference evaluates a corpus one utterance at a time (one SimulEval agent
process). Here the same sentence-level protocol runs B instances together on
one card: every 320 ms tick, each live instance's segment is ingested, ONE
batched encoder call advances every stream, the READ/WRITE decisions of each
stream (the logic of the sequential agent, ``agents/streamspeech.py``) become a
budget vector for ONE scanned MT decode, and (S2ST) the writers share ONE
emission.

Each instance's delays, MT tokens, units, wav and text equal those of the
sequential ``SentenceLevelEvaluator`` over the port's agent of the same task;
only the wall clock (``elapsed``, the _CA latency twins) differs. Three points
make that hold where the JAX host ticks (`batched_evaluator.py:356-425`,
:548-570, :585-599) do otherwise:
- a finished stream whose tail is still pending behind the lockstep clock
  waits for it before its finish decode (or, for ASR, its last write), as the
  sequential agent encodes the tail before deciding;
- (S2ST) a finished stream whose finish decode adds no token writes its final
  empty segment without an emission, as the sequential agent does (`agents/
  streamspeech.py` ``_decode_and_emit``);
- every instance is summarized, with or without ``output_dir``: the summary
  sets the intervals and silences that EndOffset, RTF and the Discontinuity
  scorers read (JAX's batched evaluator summarizes only to write its log).

The corpus runs in waves of ``batch`` instances, a fresh
``BatchedStreamingSession`` a wave (streams are position-locked, so a slot is
not refilled inside a wave); sort the corpus by length for tight waves. The
JAX evaluator's mesh sharding is not ported (ROADMAP §A item 10).

``use_fused`` (on by default, as in JAX, `batched_evaluator.py:205-213`)
runs each lockstep tick through the engine's fused tick
(``BatchedStreamingSession.fused_tick``: one encode, decode and emission of
every stream on the device, CUDA graphs on a card). A tick it does not apply
to, out of lockstep, takes the host tick; a stream whose budget exceeds the
fused scan takes the host continuation; a stream whose tail window
overflowed, the host emission. A finished stream decodes in tranches of
``fused_steps`` a tick once its whole tail is encoded, and when it stops
growing, one host decode to EOS and ONE emission finish it as the sequential
agent's finish does: no emission where the finish decode added no token.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np

from streamspeech_tpu_torch.agents.base import SpeechSegment, TextSegment
from streamspeech_tpu_torch.agents.streamspeech import (
    SAMPLE_RATE,
    StreamSpeechAgentConfig,
    spm_text,
    starts_word_table,
    text_diff,
)
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
from streamspeech_tpu_torch.eval.instance import Instance
from streamspeech_tpu_torch.ops.cmvn import GlobalCMVN
from streamspeech_tpu_torch.ops.fbank import OnlineFbank
from streamspeech_tpu_torch.runtime.batched import BatchedStreamingSession
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine


class _StreamState:
    """The policy state a stream keeps on the host (what the sequential agent
    keeps on itself)."""

    def __init__(self):
        self.fbank = OnlineFbank()
        self.src_ctc_prefix_length = 0
        self.tgt_ctc_prefix_length = 0
        self.units: List[int] = []
        self.emitted_text = ""
        self.pushed_finished = False
        self.done = False
        self.turns = 0
        self.finish_from = None      # hypothesis length when the finish decode began


class _BatchedStreamingEvaluator(SentenceLevelEvaluator):
    """Wave scheduling and the lockstep push phase; a subclass gives the
    per-tick policy and write phase of its output."""

    target_type = "speech"
    use_fused = False

    def __init__(self, engine: StreamSpeechEngine, agent_cfg: StreamSpeechAgentConfig,
                 src_dict: Dictionary, tgt_dict: Dictionary,
                 gcmvn: Optional[GlobalCMVN] = None, batch: int = 8,
                 **evaluator_kwargs):
        super().__init__(SimpleNamespace(target_type=self.target_type),
                         source_segment_size=agent_cfg.source_segment_size,
                         **evaluator_kwargs)
        self.engine = engine
        self.agent_cfg = agent_cfg
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict
        self.gcmvn = gcmvn
        self.batch = batch

    def __call__(self, sources: Sequence, references: Sequence[str],
                 sample_rate: int = 16000, continue_unfinished: bool = False
                 ) -> Dict[str, float]:
        done = self._done_indices() if continue_unfinished else set()
        log_f = self._open_log(continue_unfinished)
        todo = [i for i in range(len(sources)) if i not in done]
        for w in range(0, len(todo), self.batch):
            instances = [self._make_instance(i, sources[i], references[i], sample_rate)
                         for i in todo[w: w + self.batch]]
            self._run_wave(instances)
            for ins in instances:
                # summarize as the sequential evaluator does, log or not: it
                # sets the intervals and silences that scorers read
                summary = ins.summarize()
                self.instances[ins.index] = ins
                if log_f:
                    log_f.write(json.dumps(summary) + "\n")
                    log_f.flush()
        if log_f:
            log_f.close()
        return self.scores()

    def _run_wave(self, instances: List[Instance]) -> None:
        cfg = self.agent_cfg
        b = len(instances)
        bs = BatchedStreamingSession(self.engine, b)
        st = [_StreamState() for _ in range(b)]
        while True:
            live = [i for i in range(b) if not st[i].done and st[i].turns < self.MAX_TURNS]
            if not live:
                break
            # push phase: one segment a live instance, then one encode
            for i in live:
                seg = instances[i].send_source(self.source_segment_size)
                samples = np.asarray([] if seg.is_empty else seg.content, np.float32)
                feats = (st[i].fbank.push(samples) if len(samples)
                         else np.zeros((0, 80), np.float32))
                if self.gcmvn is not None and feats.shape[0]:
                    feats = np.asarray(self.gcmvn(feats), np.float32)
                if not st[i].pushed_finished:
                    bs.push_features(i, feats, finished=seg.finished)
                    st[i].pushed_finished = seg.finished
                st[i].turns += 1
            if not self.use_fused:
                # the fused tick encodes inside itself
                bs.encode_ready_blocks(cfg.chunk_size, cfg.conv_chunk_size)
            self._tick(bs, st, instances, live)
        for i in range(b):
            # each stream's last state, for drift and quality analysis
            instances[i].final_units = list(st[i].units)
            instances[i].final_mt_tokens = list(bs.mt_tokens[i])

    def _tick(self, bs, st, instances, live) -> None:
        raise NotImplementedError

    @staticmethod
    def _tail_pending(bs, instances, i) -> bool:
        """A finished stream whose tail still waits for the lockstep clock: the
        sequential agent encodes its tail before it decides, so the stream
        decides nothing until it is encoded."""
        return instances[i].source_finished_reading and bs.pending[i].shape[0] > 0

    def _decode_budget(self, bs, st_i, i, finished, whole_word: bool):
        """The READ/WRITE gate of the sequential agent (`batched_evaluator.py:
        169-190`): new_subword_tokens, -1 at the finish, None for READ."""
        cfg = self.agent_cfg
        if finished:
            return -1
        hyps = bs.ctc_hypotheses(i)
        asr_tokens, _ = hyps["asr"]
        st_tokens, _ = hyps["st"]
        if (len(asr_tokens) < st_i.src_ctc_prefix_length + cfg.stride_n or
                len(st_tokens) < st_i.tgt_ctc_prefix_length + cfg.stride_n):
            return None
        st_i.src_ctc_prefix_length = max(len(asr_tokens), st_i.src_ctc_prefix_length)
        st_i.tgt_ctc_prefix_length = max(len(st_tokens), st_i.tgt_ctc_prefix_length)
        subword_tokens = ((len(st_tokens) - cfg.lagging_k1) // cfg.stride_n) * cfg.stride_n
        if whole_word:
            subword_tokens += 1
        new_subword_tokens = subword_tokens - len(bs.mt_tokens[i])
        return new_subword_tokens if new_subword_tokens >= 1 else None


class BatchedS2STEvaluator(_BatchedStreamingEvaluator):
    """A ``SentenceLevelEvaluator`` for S2ST whose device work is batched over
    waves of ``batch`` instances, on the engine's device (the card unless the
    engine was made with ``device="cpu"``); ``use_fused`` as above (an engine
    without a vocoder takes the host tick)."""

    target_type = "speech"

    def __init__(self, engine, agent_cfg, src_dict, tgt_dict, unit_dict, gcmvn=None,
                 batch: int = 8, use_fused: bool = True, **evaluator_kwargs):
        super().__init__(engine, agent_cfg, src_dict, tgt_dict, gcmvn, batch,
                         **evaluator_kwargs)
        self.unit_dict = unit_dict
        self.use_fused = use_fused and engine.vocoder is not None
        self._starts_word = starts_word_table(engine, tgt_dict)

    def _tick(self, bs, st, instances, live) -> None:
        """The fused tick where it applies, else the host tick
        (`batched_evaluator.py:223-231`)."""
        if self.use_fused:
            if self._tick_fused(bs, st, instances, live):
                return
            # out of lockstep: the host tick drains what is pending
            bs.encode_ready_blocks(self.agent_cfg.chunk_size,
                                   self.agent_cfg.conv_chunk_size)
        self._tick_host(bs, st, instances, live)

    def _tick_fused(self, bs, st, instances, live) -> bool:
        """One fused tick of the wave (`batched_evaluator.py:233-314`), then
        each stream's bookkeeping; False where the tick did not apply."""
        cfg = self.agent_cfg
        b = bs.batch
        live_set = set(live)
        active = np.asarray([i in live_set and not st[i].done for i in range(b)])
        finished = np.asarray([instances[i].source_finished_reading for i in range(b)])
        out = bs.fused_tick(
            cfg.chunk_size, cfg.conv_chunk_size, cfg.lagging_k1, cfg.stride_n,
            cfg.whole_word, cfg.max_len, self._starts_word,
            [s.src_ctc_prefix_length for s in st], [s.tgt_ctc_prefix_length for s in st],
            [len(s.units) for s in st], active, finished)
        if out is None:
            return False
        drained = []
        for i in live:
            r = out[i]
            if r["grew"]:
                st[i].src_ctc_prefix_length = max(r["asr_count"],
                                                  st[i].src_ctc_prefix_length)
                st[i].tgt_ctc_prefix_length = max(r["st_count"],
                                                  st[i].tgt_ctc_prefix_length)
            if finished[i]:
                if int(bs.enc_len[i]) == 0:
                    self._final_write(instances[i], st[i])
                    continue
                if not r["tail_ready"]:
                    continue        # its tail waits for the lockstep clock
                if st[i].finish_from is None:
                    st[i].finish_from = r["prev_tokens"]
                # it decodes in tranches; drained when it stops growing
                if r["hit_eos"] or not r["do_decode"] or r["keep"] <= r["prev_tokens"]:
                    drained.append(i)
                continue
            if not r["do_decode"]:
                if r["grew"] and r["budget_over"]:
                    self._host_continue(bs, st, instances, i)
                continue
            if not r["do_emit"]:
                continue
            if r["ok"]:
                units, new_wav = r["units"], np.asarray(r["tail"])
            else:
                units, new_wav, _ = bs.emit_tail([len(s.units) for s in st])[i]
            if len(units) == 0 or len(units) <= len(st[i].units):
                continue
            st[i].units = list(units)
            self._write(instances[i], st[i], new_wav, finished=False,
                        target_finished=False)
        if drained:
            self._finish(bs, st, instances, drained)
        return True

    def _finish(self, bs, st, instances, drained) -> None:
        """The sequential agent's finish for the drained streams: decode the
        rest to EOS (usually nothing: the tranches reached it), then, where
        the finish decode added a token, ONE emission and the final write."""
        budgets = np.zeros((bs.batch,), np.int64)
        budgets[drained] = -1
        bs.mt_decode(budgets, max_len=self.agent_cfg.max_len)
        writers = [i for i in drained if len(bs.mt_tokens[i]) > st[i].finish_from]
        outs = bs.emit_tail([len(s.units) for s in st]) if writers else None
        for i in drained:
            if i not in writers:
                self._final_write(instances[i], st[i])
                continue
            units, new_wav, _ = outs[i]
            if len(units) == 0 or len(units) <= len(st[i].units):
                self._final_write(instances[i], st[i])
                continue
            st[i].units = list(units)
            self._write(instances[i], st[i], new_wav, finished=True, target_finished=True)

    def _host_continue(self, bs, st, instances, i) -> None:
        """The host decode of one streaming stream whose budget exceeded the
        fused scan (`batched_evaluator.py:316-354`, the sequential agent's
        continuation in ``_fused_action``)."""
        cfg = self.agent_cfg
        st_tokens, _ = bs.ctc_hypotheses(i)["st"]
        subword = ((len(st_tokens) - cfg.lagging_k1) // cfg.stride_n) * cfg.stride_n
        if cfg.whole_word:
            subword += 1
        new_sub = subword - len(bs.mt_tokens[i])
        if new_sub < 1:
            return
        budgets = np.zeros((bs.batch,), np.int64)
        budgets[i] = new_sub
        prev_tokens = list(bs.mt_tokens[i])
        bs.mt_decode(budgets, max_len=cfg.max_len)
        if cfg.whole_word:
            toks = bs.mt_tokens[i]
            j = 0
            for j in range(len(toks) - 1, -1, -1):
                if self.tgt_dict[toks[j]].startswith("▁"):
                    break
            bs.mt_truncate(i, j)
            if j == 0:
                return
        if len(bs.mt_tokens[i]) <= len(prev_tokens):
            return
        units, new_wav, _ = bs.emit_tail([len(s.units) for s in st])[i]
        if len(units) == 0 or len(units) <= len(st[i].units):
            return
        st[i].units = list(units)
        self._write(instances[i], st[i], new_wav, finished=False, target_finished=False)

    def _tick_host(self, bs, st, instances, live) -> None:
        """The host tick of every live stream (`batched_evaluator.py:356-425`
        ``_tick_host``), in the sequential agent's order: decisions → one
        decode → whole-word rollback → one emission."""
        cfg = self.agent_cfg
        budgets = np.zeros((bs.batch,), np.int64)
        wants = {}   # stream -> (finished, new_subword_tokens, prev_tokens)
        for i in live:
            finished = instances[i].source_finished_reading
            if self._tail_pending(bs, instances, i):
                continue
            if int(bs.enc_len[i]) == 0:
                if finished:
                    self._final_write(instances[i], st[i])
                continue
            new_sub = self._decode_budget(bs, st[i], i, finished, cfg.whole_word)
            if new_sub is None:
                continue  # READ
            budgets[i] = new_sub
            prev = bs.mt_tokens[i]
            if finished and st[i].finish_from is not None:
                prev = prev[:st[i].finish_from]   # fused tranches began its finish
            wants[i] = (finished, new_sub, list(prev))

        if wants:
            bs.mt_decode(budgets, max_len=cfg.max_len)

        writers = []
        for i, (finished, new_sub, prev_tokens) in wants.items():
            if cfg.whole_word and not finished:
                toks = bs.mt_tokens[i]
                j = 0
                for j in range(len(toks) - 1, -1, -1):
                    if self.tgt_dict[toks[j]].startswith("▁"):
                        break
                bs.mt_truncate(i, j)
                if j == 0:
                    continue  # READ
            if bs.mt_tokens[i] == prev_tokens or (
                    not finished and len(bs.mt_tokens[i]) <= len(prev_tokens)):
                if finished:
                    self._final_write(instances[i], st[i])
                continue
            writers.append(i)

        if writers:
            outs = bs.emit_tail([len(s.units) for s in st])
            for i in writers:
                finished, new_sub, _ = wants[i]
                units, new_wav, _ = outs[i]
                if len(units) == 0 or len(units) <= len(st[i].units):
                    if finished:
                        self._final_write(instances[i], st[i])
                    continue
                st[i].units = units
                self._write(instances[i], st[i], new_wav, finished=finished,
                            target_finished=finished and new_sub == -1)

    def _final_write(self, instance: Instance, state: _StreamState) -> None:
        self._write(instance, state, np.zeros((0,), np.float32), finished=True,
                    target_finished=True)

    def _write(self, instance: Instance, state: _StreamState, wav: np.ndarray,
               finished: bool, target_finished: bool) -> None:
        instance.receive_prediction(SpeechSegment(
            content=np.asarray(wav).tolist(), sample_rate=SAMPLE_RATE, finished=finished))
        if target_finished or instance.finish_prediction:
            state.done = True


class BatchedS2TTEvaluator(_BatchedStreamingEvaluator):
    """A ``SentenceLevelEvaluator`` for simultaneous speech-to-text translation
    whose device work is batched over waves of ``batch`` instances (JAX
    `batched_evaluator.py:436-576`), each instance equal to the sequential
    ``StreamSpeechS2TTAgent``'s. ``use_fused`` (the default) runs each
    lockstep tick through the engine's fused tick without its emission
    (``fused_tick(..., with_emission=False)``, CUDA graphs on a card; no
    vocoder needed, where JAX takes it only with one); a tick it does not
    apply to takes the host tick, a stream whose budget exceeds the fused
    scan the host continuation. A finished stream decodes in tranches once
    its whole tail is encoded and, when it stops growing, one host decode to
    EOS and its final write finish it.

    JAX's host tick decodes a finished stream whose tail still waits behind
    the lockstep clock, from the frames before it, and so departs from its
    own sequential agent there; this one waits for the tail, as the
    sequential agent encodes it before deciding."""

    target_type = "text"

    def __init__(self, engine, agent_cfg, src_dict, tgt_dict, gcmvn=None,
                 batch: int = 8, use_fused: bool = True, **evaluator_kwargs):
        super().__init__(engine, agent_cfg, src_dict, tgt_dict, gcmvn, batch,
                         **evaluator_kwargs)
        self.use_fused = use_fused
        # whole_word is off for S2TT; the fused tick still takes the table
        self._starts_word = np.zeros((engine.model.cfg.mt_decoder.vocab_size,), bool)

    def _tick(self, bs, st, instances, live) -> None:
        if self.use_fused:
            if self._tick_fused(bs, st, instances, live):
                return
            bs.encode_ready_blocks(self.agent_cfg.chunk_size,
                                   self.agent_cfg.conv_chunk_size)
        self._tick_host(bs, st, instances, live)

    def _tick_fused(self, bs, st, instances, live) -> bool:
        """One fused tick of the wave without the emission (`batched_evaluator.
        py:476-519`); False where it did not apply."""
        cfg = self.agent_cfg
        b = bs.batch
        live_set = set(live)
        active = np.asarray([i in live_set and not st[i].done for i in range(b)])
        finished = np.asarray([instances[i].source_finished_reading for i in range(b)])
        out = bs.fused_tick(
            cfg.chunk_size, cfg.conv_chunk_size, cfg.lagging_k1, cfg.stride_n, False,
            cfg.max_len, self._starts_word,
            [s.src_ctc_prefix_length for s in st], [s.tgt_ctc_prefix_length for s in st],
            np.zeros((b,), np.int64), active, finished, with_emission=False)
        if out is None:
            return False
        drained = []
        for i in live:
            r = out[i]
            if r["grew"]:
                st[i].src_ctc_prefix_length = max(r["asr_count"],
                                                  st[i].src_ctc_prefix_length)
                st[i].tgt_ctc_prefix_length = max(r["st_count"],
                                                  st[i].tgt_ctc_prefix_length)
            if finished[i]:
                if int(bs.enc_len[i]) == 0:
                    self._write_text(instances[i], st[i], "", True)
                elif r["tail_ready"] and (r["hit_eos"] or not r["do_decode"]
                                          or r["keep"] <= r["prev_tokens"]):
                    drained.append(i)
                continue
            if not r["do_decode"]:
                if r["grew"] and r["budget_over"]:
                    self._host_continue(bs, st, instances, i)
                continue
            if r["keep"] > r["prev_tokens"]:
                self._emit_text_diff(st, instances, i, bs.mt_tokens[i], finished=False)
        if drained:
            budgets = np.zeros((b,), np.int64)
            budgets[drained] = -1
            bs.mt_decode(budgets, max_len=cfg.max_len)
            for i in drained:
                self._emit_text_diff(st, instances, i, bs.mt_tokens[i], finished=True)
        return True

    def _host_continue(self, bs, st, instances, i) -> None:
        """The host decode of one streaming stream whose budget exceeded the
        fused scan (`batched_evaluator.py:530-546`)."""
        cfg = self.agent_cfg
        st_tokens, _ = bs.ctc_hypotheses(i)["st"]
        new_sub = ((len(st_tokens) - cfg.lagging_k1) // cfg.stride_n) * cfg.stride_n \
            - len(bs.mt_tokens[i])
        if new_sub < 1:
            return
        budgets = np.zeros((bs.batch,), np.int64)
        budgets[i] = new_sub
        prev = list(bs.mt_tokens[i])
        bs.mt_decode(budgets, max_len=cfg.max_len)
        if bs.mt_tokens[i] != prev:
            self._emit_text_diff(st, instances, i, bs.mt_tokens[i], finished=False)

    def _tick_host(self, bs, st, instances, live) -> None:
        """The host tick (`batched_evaluator.py:548-570`) in the sequential
        agent's order: decisions → one decode → each stream's text diff."""
        cfg = self.agent_cfg
        budgets = np.zeros((bs.batch,), np.int64)
        wants = {}
        for i in live:
            finished = instances[i].source_finished_reading
            if self._tail_pending(bs, instances, i):
                continue
            if int(bs.enc_len[i]) == 0:
                if finished:
                    self._write_text(instances[i], st[i], "", True)
                continue
            new_sub = self._decode_budget(bs, st[i], i, finished, whole_word=False)
            if new_sub is None:
                continue  # READ
            budgets[i] = new_sub
            wants[i] = (finished, list(bs.mt_tokens[i]))
        if wants:
            bs.mt_decode(budgets, max_len=cfg.max_len)
        for i, (finished, prev) in wants.items():
            if bs.mt_tokens[i] == prev and not finished:
                continue  # READ
            self._emit_text_diff(st, instances, i, bs.mt_tokens[i], finished)

    def _emit_text_diff(self, st, instances, i, tokens, finished: bool) -> None:
        """The sequential agent's write: the hypothesis's new text, none (READ)
        where there is none before the finish."""
        full_text = spm_text(self.tgt_dict, tokens)
        new_text = text_diff(full_text, st[i].emitted_text)
        st[i].emitted_text = full_text
        if new_text or finished:
            self._write_text(instances[i], st[i], new_text, finished)

    def _write_text(self, instance: Instance, state: _StreamState, text: str,
                    finished: bool) -> None:
        instance.receive_prediction(TextSegment(content=text, finished=finished))
        if finished or instance.finish_prediction:
            state.done = True


class BatchedASREvaluator(BatchedS2TTEvaluator):
    """Wave-batched streaming ASR (JAX `batched_evaluator.py:578-599`), each
    instance equal to the sequential ``StreamSpeechASRAgent``'s: the batched
    encoder alone runs on the device, then each stream writes the new text of
    its ASR CTC hypothesis. As in the S2TT evaluator, a finished stream
    writes its last text only once its tail is encoded (JAX's writes it from
    the frames before)."""

    def __init__(self, engine, agent_cfg, src_dict, tgt_dict, gcmvn=None,
                 batch: int = 8, **evaluator_kwargs):
        super().__init__(engine, agent_cfg, src_dict, tgt_dict, gcmvn, batch,
                         use_fused=False, **evaluator_kwargs)

    def _tick(self, bs, st, instances, live) -> None:
        for i in live:
            finished = instances[i].source_finished_reading
            if self._tail_pending(bs, instances, i):
                continue
            asr_tokens, _ = bs.ctc_hypotheses(i)["asr"]
            full_text = spm_text(self.src_dict, asr_tokens)
            new_text = text_diff(full_text, st[i].emitted_text)
            if not new_text and not finished:
                continue
            st[i].emitted_text = full_text
            self._write_text(instances[i], st[i], new_text, finished)
