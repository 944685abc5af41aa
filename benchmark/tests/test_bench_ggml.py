"""The benchmark's GGUF block codecs: the decoders the references read
weights with, on blocks worked out by hand, and the encoder's bytes as
the program's own decoder reads them."""

import numpy as np
import pytest
import torch

import _paths  # noqa: F401
import ggml


def _q4k_block():
    d, dmin = np.float16(0.5), np.float16(0.25)
    # sc[0..3] = 1, 2, 3, 4 (byte 0 also carries the top bits of sc[4]),
    # m[0..3] = 10..13, sc[4..7] / m[4..7] in the low / high nibbles of
    # bytes 8..11
    scales = [0x41, 2, 3, 4, 10, 11, 12, 13, 0x21, 0x43, 0x65, 0x87]
    qs = [(l % 16) | ((15 - l % 16) << 4) for _ in range(4) for l in range(32)]
    raw = (np.array([d, dmin], np.float16).view(np.uint8).tolist()
           + scales + qs)
    sc = [1, 2, 3, 4, 1 + 16, 3, 5, 7]
    m = [10, 11, 12, 13, 2, 4, 6, 8]
    want = np.zeros(256, np.float32)
    for c in range(4):
        for l in range(32):
            want[c * 64 + l] = 0.5 * sc[2 * c] * (l % 16) - 0.25 * m[2 * c]
            want[c * 64 + 32 + l] = (0.5 * sc[2 * c + 1] * (15 - l % 16)
                                     - 0.25 * m[2 * c + 1])
    return torch.tensor(raw, dtype=torch.uint8).reshape(1, 144), want


def test_q4_k_decodes_a_block_worked_by_hand():
    block, want = _q4k_block()
    np.testing.assert_array_equal(ggml.decode_q4_k(block).numpy(), want)


def test_q8_0_decodes_a_block_worked_by_hand():
    q = np.arange(-127, 129, 8, dtype=np.int64)[:32].clip(-127, 127)
    raw = (np.array([0.125], np.float16).view(np.uint8).tolist()
           + q.astype(np.int8).view(np.uint8).tolist())
    block = torch.tensor(raw, dtype=torch.uint8).reshape(1, 34)
    np.testing.assert_array_equal(ggml.decode_q8_0(block).numpy(),
                                  (0.125 * q).astype(np.float32))


@pytest.mark.parametrize("fmt,tol", [("Q4_K", 0.12), ("Q8_0", 0.01)])
def test_encoder_round_trips_and_agrees_with_the_program(fmt, tol):
    from comfyui_gguf_tpu_torch.gguf.constants import \
        GGMLQuantizationType as Q
    from comfyui_gguf_tpu_torch.quant import codecs

    g = torch.Generator().manual_seed(3)
    w = torch.randn(32, 1024, generator=g) * 0.03
    blocks = ggml.ENCODE[fmt](w)
    assert blocks.shape[1] == ggml.BLOCK[fmt][1]
    mine = ggml.decode(fmt, blocks, w.shape)
    theirs = codecs.dequantize(blocks.numpy(), Q[fmt], tuple(w.shape))
    np.testing.assert_array_equal(mine.numpy(), theirs)
    assert float((mine - w).norm() / w.norm()) < tol
    assert ggml.nbytes(fmt, w.numel()) == blocks.numel()
