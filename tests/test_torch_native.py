"""The port's packers (``llmc_tpu_torch.native``, torch ops on the input's
device) bit for bit against the JAX package's C++ library
(``llmc_tpu/native/packing.cpp`` through ctypes) and its numpy twins
(the library's fallbacks, reached by hiding the library), and the
export formats' layouts (the counterparts of ``tests/test_native.py`` and
``tests/test_opt_and_export.py``'s packing tests)."""

import contextlib

import numpy as np
import pytest
import torch

import llmc_tpu.native as jnat
from llmc_tpu.export import formats as jfmt
from llmc_tpu_torch import native as tnat
from llmc_tpu_torch.export import formats as tfmt

torch.set_num_threads(1)


@contextlib.contextmanager
def numpy_twins():
    """The reference's numpy fallbacks: its library hidden."""
    load = jnat._load
    jnat._load = lambda: None
    try:
        yield
    finally:
        jnat._load = load


def codes(shape, seed, high=256):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.uint8)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_the_reference_library_is_built():
    assert jnat.available()


@pytest.mark.parametrize('bits', [2, 4, 8])
@pytest.mark.parametrize('K', [64, 61])
def test_pack_int32_rows_is_bit_equal(bits, K):
    """Every code byte (fields wider than ``bits`` spill into the next, as
    in the C++), and K off a multiple of the pack factor; the numpy twins
    on codes within ``bits``."""
    c = codes((8, K), bits * K)
    got = tnat.pack_int32_rows(t(c), bits).numpy()
    assert got.dtype == np.int32 and got.shape == (8, -(-K // (32 // bits)))
    np.testing.assert_array_equal(got, jnat.pack_int32_rows(c, bits))
    inrange = c & ((1 << bits) - 1)
    with numpy_twins():
        refs = (jnat.pack_int32_rows(inrange, bits),
                jfmt.pack_int32_rows(inrange, bits))
    for ref in refs:
        np.testing.assert_array_equal(
            tnat.pack_int32_rows(t(inrange), bits).numpy(), ref)


@pytest.mark.parametrize('bits', [4, 8])
def test_pack_awq_order_is_bit_equal(bits):
    """Pack factors 8 and 4: the C++ masks each code to its bits and orders
    a word's columns by [0, 2, 4, 6, 1, 3, 5, 7] or [0, 2, 1, 3]; the numpy
    twin agrees at pack factor 8 (it indexes past its 4 columns at 4)."""
    c = codes((16, 64), bits)
    got = tnat.pack_awq_order(t(c), bits).numpy()
    np.testing.assert_array_equal(got, jnat.pack_awq_order(c, bits))
    if bits == 4:
        inrange = c & 0xF
        with numpy_twins():
            want = jnat.pack_awq_order(inrange, 4)
        np.testing.assert_array_equal(
            tnat.pack_awq_order(t(inrange), 4).numpy(), want)
    back = tnat.unpack_awq_order(torch.from_numpy(got), bits).numpy()
    np.testing.assert_array_equal(back, c & ((1 << bits) - 1))
    with pytest.raises(ValueError, match='4 or 8 bits'):
        tnat.pack_awq_order(t(c), 2)


@pytest.mark.parametrize('K,gs', [(256, 128), (128, 128), (96, 16)])
def test_int4_colsplit_is_bit_equal_and_round_trips(K, gs):
    c = codes((32, K), K, high=16)
    with numpy_twins():
        want = jnat.pack_int4_colsplit(c, gs)
    lib = jnat.pack_int4_colsplit(c, gs)
    got = tnat.pack_int4_colsplit(t(c), gs)
    assert got.dtype == torch.int8 and got.shape == (32, K // 2)
    np.testing.assert_array_equal(got.numpy(), lib)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tnat.unpack_int4_colsplit(got, gs).numpy()
    np.testing.assert_array_equal(back, c)
    np.testing.assert_array_equal(back, jnat.unpack_int4_colsplit(lib, gs))


def test_bf16_conversions_are_bit_equal():
    """Round to nearest even on random values, ties, the largest finite
    values, infinities and NaNs; bf16 bits back to float32, from int16 bits
    and from a bfloat16 tensor."""
    rng = np.random.RandomState(2)
    x = np.concatenate([
        rng.randn(4096).astype(np.float32),
        np.array([0x3F808000, 0x3F818000, 0x7F7FFFFF, 0xFF7FFFFF,
                  0x7F800000, 0xFF800000, 0x7FC00001, 0x7F800001,
                  0x00000001, 0x80000000], np.uint32).view(np.float32)])
    got = tnat.f32_to_bf16_bits(t(x)).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, jnat.f32_to_bf16_bits(x))
    with numpy_twins():
        np.testing.assert_array_equal(got, jnat.f32_to_bf16_bits(x))
    want = jnat.bf16_to_f32(got).view(np.uint32)
    back = tnat.bf16_to_f32(t(got.view(np.int16))).numpy().view(np.uint32)
    np.testing.assert_array_equal(back, want)
    fin = np.isfinite(x)
    bf = tnat.bf16_to_f32(t(x[fin]).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(bf.view(np.uint32), want[fin])


def test_vllm_pack_round_trip():
    c = codes((8, 64), 0, high=16)
    packed = tfmt.pack_int32_rows(t(c), 4).numpy()
    assert packed.shape == (8, 8) and packed.dtype == np.int32
    u = packed.view(np.uint32)
    rec = np.zeros_like(c)
    for i in range(8):
        rec[:, i::8] = (u >> (4 * i)) & 0xF
    np.testing.assert_array_equal(rec, c)


@pytest.mark.parametrize('zeros_dtype', [np.float32, np.int8])
def test_awq_gemm_layout_matches_the_reference(zeros_dtype):
    rng = np.random.RandomState(1)
    oc, ic, gs = 16, 32, 16
    c = codes((oc, ic), 1, high=16)
    scales = rng.rand(oc, ic // gs).astype(np.float32)
    zeros = rng.randint(0, 16, (oc, ic // gs)).astype(zeros_dtype)
    want = jfmt.export_awq_gemm_linear(c, scales, zeros, 4, gs)
    got = tfmt.export_awq_gemm_linear(t(c), t(scales), t(zeros), 4, gs)
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        assert g.dtype == want[k].dtype and g.shape == want[k].shape
        np.testing.assert_array_equal(g.view(np.uint8),
                                      want[k].view(np.uint8))
    u = got['qweight'].numpy().view(np.uint32)
    rec = np.zeros((ic, oc), np.uint8)
    for i in range(8):
        rec[:, tnat.AWQ_ORDER[i]::8] = (u >> (4 * i)) & 0xF
    np.testing.assert_array_equal(rec, c.T)


@pytest.mark.parametrize('signed,need_pack', [(True, True), (False, True),
                                              (True, False), (False, False)])
def test_vllm_linear_matches_the_reference(signed, need_pack):
    """Signed codes offset by 2^(bits-1) when packed; int8 codes and zero
    points wrap modulo 2^8 as numpy's ``astype(np.int8)`` does (8-bit
    unsigned codes and zero points above 127)."""
    rng = np.random.RandomState(3)
    bits = 4 if need_pack else 8
    if signed:
        c = rng.randint(-2 ** (bits - 1), 2 ** (bits - 1), (8, 64)).astype(
            np.int8)
        zeros = None
    else:
        c = codes((8, 64), 3, high=2 ** bits)
        zeros = rng.randint(0, 2 ** bits, (8, 2)).astype(np.float32)
    scales = rng.rand(8, 2).astype(np.float32)
    want = jfmt.export_vllm_linear(c, scales, zeros, bits, need_pack)
    got = tfmt.export_vllm_linear(t(c), t(scales),
                                  None if zeros is None else t(zeros), bits,
                                  need_pack)
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy()
        assert g.dtype == want[k].dtype and g.shape == want[k].shape
        np.testing.assert_array_equal(g, want[k])


def test_config_stamps_match_the_reference():
    w = dict(bit=4, symmetric=False, granularity='per_group', group_size=128,
             need_pack=True)
    a = dict(bit=8, symmetric=True, granularity='per_token')
    for q in (dict(weight=w), dict(weight=w, act=a),
              dict(weight=dict(w, quant_type='float-quant', bit='e4m3'))):
        assert tfmt.vllm_quant_config(q) == jfmt.vllm_quant_config(q)
        assert tfmt.awq_quant_config(q) == jfmt.awq_quant_config(q)
