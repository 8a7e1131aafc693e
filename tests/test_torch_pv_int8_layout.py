"""The int8-P.V forward's v8 layout (``ops/flash_attention.py``): the plain
mirror of the wgmma path's pre-pass, ``_plain_v8``, against the
quantization that ``_plain_pv_int8`` applies, and the key permutation
inside each 32-key step, mirrored from the kernel's packing of p8 into the
s8 wgmma A fragment (``csrc/flash_attention_pv_int8.cu``).  The kernel
itself runs only on the card (``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from ldm_tf2_tpu_torch.ops import flash_attention as tfa


def _codes_per_block(v, bk):
    """The plain codes and scales of each JAX block, in numpy float32 by the
    JAX kernel's formula: sv = max(amax |v|, 1e-8) / 127 per (b, h, block),
    v8 = clip(round(v * (1 / sv)), -127, 127)."""
    b, tk, h, s = v.shape
    codes = np.zeros((b, h, tk, s), np.float32)
    svs = []
    for j in range(-(-tk // bk)):
        vb = v[:, j * bk:(j + 1) * bk].transpose(0, 2, 1, 3)  # [b, h, keys, s]
        amax = np.abs(vb).max(axis=(2, 3), keepdims=True)
        sv = np.maximum(amax, np.float32(1e-8)) * np.float32(1.0 / 127.0)
        inv = np.float32(1.0) / sv
        codes[:, :, j * bk:(j + 1) * bk] = np.clip(np.round(vb * inv), -127, 127)
        svs.append(sv.reshape(b * h))
    return codes, np.stack(svs, axis=1)


def _unpermute(v8, tk):
    """v8 [B * H, rows, keys] back to key order, [B * H, rows, tk]."""
    slots = np.array(tfa.V8_KEY_SLOTS)
    keys = np.arange(tk)
    return v8[..., keys // 32 * 32 + slots[keys % 32]]


@pytest.mark.parametrize("b,tk,h,s", [(1, 1024, 2, 40), (1, 1000, 2, 40), (1, 1024, 1, 512)])
def test_pre_pass_mirror_unpermutes_to_the_plain_codes(b, tk, h, s):
    rng = np.random.default_rng(7)
    v = (rng.standard_normal((b, tk, h, s)) * 1.5).astype(np.float32)
    rows, keys = tfa.v8_layout(s, tk)
    assert rows >= s and rows % 16 == 0 and keys == -(-tk // 128) * 128
    v8, sv = tfa._plain_v8(torch.from_numpy(v), rows, keys)
    assert v8.dtype == torch.int8 and tuple(v8.shape) == (b * h, rows, keys)
    v8 = v8.numpy().astype(np.int32)
    bk = tfa.jax_block_k(s, tk)
    want, want_sv = _codes_per_block(v, bk)
    want = want.transpose(0, 1, 3, 2).reshape(b * h, s, tk)
    got = _unpermute(v8, tk)
    np.testing.assert_array_equal(got[:, :s], want)
    np.testing.assert_array_equal(sv.numpy(), want_sv)
    # columns past S and keys past Tk are zeros
    assert not v8[:, s:].any()
    assert not np.delete(v8, _unpermute(np.arange(keys)[None, None], tk)[0, 0], axis=-1).any()
    # the plain version quantizes v with the same codes and scales
    vb = torch.from_numpy(v[:, :bk]).permute(0, 2, 1, 3)
    codes, scales = tfa._quantize_v_block(vb)
    np.testing.assert_array_equal(codes.permute(0, 1, 3, 2).reshape(b * h, s, -1).numpy(),
                                  want[:, :, :min(bk, tk)])
    np.testing.assert_array_equal(scales.reshape(-1).numpy(), want_sv[:, 0])
    # dequantized, the codes are v to half a step of their block
    sv_key = want_sv[:, np.arange(tk) // bk].reshape(b, h, 1, tk)
    err = np.abs(want.reshape(b, h, s, tk) * sv_key - v.transpose(0, 2, 3, 1))
    assert (err <= sv_key * 0.5 * (1 + 1e-5)).all()


def test_key_permutation_is_a_bijection_on_each_step():
    slots = tfa.V8_KEY_SLOTS
    assert sorted(slots) == list(range(32))
    # each thread t of a quad finds its two keys of every n8 block at its
    # own four bytes of each 16-byte half
    for key in range(32):
        t = key % 8 // 2
        assert slots[key] % 16 // 4 == t and slots[key] // 16 == key // 16


def _a_operand(p8):
    """The s8 A operand of one warpgroup as the kernel packs it from the
    score accumulator of a 64-key K tile: [64 rows, 64 slots], slot 32 kk +
    16 (r / 2) + 4t + e of register r, k-step kk; each accumulator element
    placed once."""
    a = np.full((64, 64), -1000, np.int64)
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for kk in range(2):
                for r in range(4):
                    for e in range(4):
                        j = 4 * kk + 2 * (r // 2) + e // 2
                        row = 16 * w + g + 8 * (r % 2)
                        key = 8 * j + 2 * t + e % 2  # accumulator column
                        slot = 32 * kk + 16 * (r // 2) + 4 * t + e
                        assert a[row, slot] == -1000
                        a[row, slot] = p8[row, key]
    assert (a != -1000).all()
    return a


@pytest.mark.parametrize("s", [40, 512])
def test_permuted_product_equals_plain_in_integers(s):
    rng = np.random.default_rng(11)
    tk = 128  # one v8 tile: two 64-key K tiles
    p8 = rng.integers(0, 128, (64, tk))
    v = rng.standard_normal((1, tk, 1, s)).astype(np.float32)
    rows, keys = tfa.v8_layout(s, tk)
    v8, _ = tfa._plain_v8(torch.from_numpy(v), rows, keys)
    v8 = v8.numpy()[0].astype(np.int64)  # [rows, keys]: the K-major B operand
    codes = _unpermute(v8, tk)  # [rows, keys] in key order
    for half in range(2):  # the two K tiles of the v8 tile
        keys_h = slice(64 * half, 64 * half + 64)
        a = _a_operand(p8[:, keys_h])
        got = a @ v8[:, keys_h].T  # what wgmma sums over the slots
        want = p8[:, keys_h] @ codes[:, keys_h].T
        np.testing.assert_array_equal(got, want)
