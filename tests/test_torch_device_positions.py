"""The device write positions of the caches and the encoder (the fused tick's
first two modules): ``KVCache`` writes at its device ``pos`` with
``index_copy_`` and builds its valid mask from it, and ``encode_block`` reads
the encoder's stream position from ``EncoderStreamState.pos_dev`` (gathering
the rel-pos table's rows at it). Held bitwise, over several blocks, against
the host-integer form they replaced, restated here: slice writes at the host
index, the table sliced at the host position. One stream with whole blocks,
and two in lockstep with a tail inside a block (the per-row valid lengths);
the encoder rows, every cache and the MT cross caches filled from them.
No JAX.
"""

import numpy as np
import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.models.layers import KVCache
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.weights import doctor_params, random_init_

CHUNK, CONV_CHUNK, BLOCK, MAX_FRAMES = 4, 8, 32, 64


class HostIntKVCache(KVCache):
    """The cache before its write position moved to the device: slice writes
    at the host ``index``, the valid mask from it."""

    def append(self, k_new, v_new):
        s = k_new.shape[1]
        end = self.index + s
        if end > self.max_len:
            raise ValueError("overflow")
        self.k[:, self.index:end] = k_new.to(self.k.dtype)
        self.v[:, self.index:end] = v_new.to(self.v.dtype)
        self.index = end
        return self.k, self.v, torch.arange(self.max_len) < end

    def valid(self):
        return torch.arange(self.max_len) < self.index


def host_int_encode_block(encoder, block, state, valid_len=None):
    """``ChunkConformerEncoder.encode_block`` in its host-integer form."""
    x, state.sub_ctx = encoder.subsample.step(block, state.sub_ctx, CONV_CHUNK, valid_len)
    s = x.shape[1]
    x = encoder.linear(x * encoder.embed_scale)
    pos = state.pos
    start = (MAX_FRAMES + s - 1) - (pos + s - 1)
    pos_emb = encoder._rel_table(MAX_FRAMES + s, x.device)[start:start + s + MAX_FRAMES]
    q_abs = pos + torch.arange(s)[:, None]
    j_abs = torch.arange(MAX_FRAMES)[None, :]
    allowed = j_abs < (q_abs // CHUNK + 1) * CHUNK
    frame_valid = None
    if torch.is_tensor(valid_len):
        enc_end = pos - (-valid_len // 4)
        allowed = allowed[None] & (j_abs[None] < enc_end[:, None, None])
        frame_valid = (pos + torch.arange(s))[None] < enc_end[:, None]
    for i, layer in enumerate(encoder.layers()):
        x, state.kv[i], state.conv_ctx[i] = layer.step(
            x, pos_emb, allowed, state.kv[i], state.conv_ctx[i], pos, CONV_CHUNK,
            frame_valid)
    state.pos = pos + s
    return x


@pytest.fixture(scope="module")
def model():
    return doctor_params(random_init_(StreamSpeechModel(tiny_config()), 3)).eval()


def _host_int_state(model, batch):
    state = model.encoder_stream_init(batch, MAX_FRAMES, "cpu")
    state.kv = [HostIntKVCache(kv.k, kv.v) for kv in state.kv]
    return state


def _cross(model, batch, cls):
    dc = model.cfg.mt_decoder
    h = dc.attention_heads
    return [cls(*(torch.zeros(batch, MAX_FRAMES, h, dc.embed_dim // h) for _ in "kv"))
            for _ in range(dc.layers)]


@pytest.mark.parametrize("valid", [None, (BLOCK, 19)])
def test_device_positions_equal_the_host_int_form_bitwise(model, valid):
    batch = 1 if valid is None else 2
    rng = np.random.RandomState(0)
    blocks = [torch.from_numpy(rng.randn(batch, BLOCK, 80).astype(np.float32))
              for _ in range(5)]
    dev_state = model.encoder_stream_init(batch, MAX_FRAMES, "cpu")
    int_state = _host_int_state(model, batch)
    dev_cross, int_cross = _cross(model, batch, KVCache), _cross(model, batch, HostIntKVCache)
    with torch.no_grad():
        for n, block in enumerate(blocks):
            # the two-stream case: row 1 ends inside the fourth block
            vl = None if valid is None else torch.tensor(
                [BLOCK, valid[1] if n == 3 else (0 if n > 3 else BLOCK)])
            enc_dev, dev_state = model.encoder.encode_block(block, dev_state, CHUNK,
                                                            CONV_CHUNK, vl)
            enc_int = host_int_encode_block(model.encoder, block, int_state, vl)
            assert torch.equal(enc_dev, enc_int), n
            model.mt_fill_cross(enc_dev, dev_cross)
            model.mt_fill_cross(enc_int, int_cross)
            assert dev_state.pos == int_state.pos == int(dev_state.pos_dev) \
                == (n + 1) * BLOCK // 4
            for a, b in zip(dev_state.sub_ctx + dev_state.conv_ctx,
                            int_state.sub_ctx + int_state.conv_ctx):
                assert torch.equal(a, b), n
            for a, b in zip(dev_state.kv + dev_cross, int_state.kv + int_cross):
                assert a.index == b.index == int(a.pos), n
                assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v), n
                assert torch.equal(a.valid(), b.valid()), n


def test_kv_cache_truncate_moves_the_device_position():
    cache = KVCache.create(1, 8, 1, 2, "cpu")
    cache.append(torch.ones(1, 5, 1, 2), torch.ones(1, 5, 1, 2))
    cache.truncate(3)
    assert cache.index == int(cache.pos) == 3
    _, _, valid = cache.append(torch.full((1, 2, 1, 2), 2.0), torch.zeros(1, 2, 1, 2))
    assert valid.tolist() == [True] * 5 + [False] * 3
    assert cache.k[0, :, 0, 0].tolist() == [1, 1, 1, 2, 2, 0, 0, 0]
