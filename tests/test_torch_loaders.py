"""The port's checkpoint loaders against the JAX package's, bit for bit.

On the same file (llama2c, FLM at INT8/INT16/INT4, GGUF with F32, F16 and
``Q8_0`` tensors, HF ``.bin`` and ``.safetensors`` directories), the
port's ``load_model`` gives the JAX ``load_model``'s config, every weight
array or ``(data, scales)`` pair and the tokenizer's texts, scores and
types.  ``build_params`` equals JAX's leaf for leaf (NONE, INT8, INT16,
INT4 packed and with the 512-padding of the hidden size), ``write_flm``
writes JAX's bytes (from numpy or torch inputs), and the numpy,
deinterleave and padding helpers are bit-equal.  The safetensors reader
is held against the ``safetensors`` package's own files.  Fixtures are
written here from ``fastllama_tpu.tools.synthetic``."""
import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

from fastllama_tpu import config as jcfg
from fastllama_tpu.loaders import flm as jflm
from fastllama_tpu.loaders import hf as jhf
from fastllama_tpu.loaders import registry as jreg
from fastllama_tpu.models import llama as jl
from fastllama_tpu.ops import rope as jrope
from fastllama_tpu.parallel import sharding as jsh
from fastllama_tpu.quant import groupquant as jgq
from fastllama_tpu.tools import synthetic as jsyn
from fastllama_tpu_torch import config as tcfg
from fastllama_tpu_torch.loaders import flm as tflm
from fastllama_tpu_torch.loaders import hf as thf
from fastllama_tpu_torch.loaders import registry as treg
from fastllama_tpu_torch.models import llama as tl
from fastllama_tpu_torch.ops import rope as trope
from fastllama_tpu_torch.parallel import sharding as tsh
from fastllama_tpu_torch.quant import groupquant as tgq
from fastllama_tpu_torch.tools import synthetic as tsyn
from tests.torch_loader_files import write_gguf, write_hf


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many tiny ops: one intra-op thread keeps them fast when the suite's
    workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = jsyn.TINY
# packs at INT4 (contraction extents multiples of 1024)
WIDE = TINY.replace(dim=1024, hidden_dim=1024, n_heads=8, n_kv_heads=4,
                    n_layers=1)


def tcfg_of(jc):
    """The JAX config as the port's."""
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    for k in ("arch", "act_type", "quant_type"):
        kw[k] = type(getattr(tcfg.ModelConfig(1, 1, 1, 1, 1, 1, 1), k))(
            kw[k].value)
    return tcfg.ModelConfig(**kw)


def same_config(jc, tc):
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if hasattr(a, "value"):
            a, b = a.value, b.value
        assert a == b, (f.name, a, b)


def same_array(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), name


def same_weights(jw, tw):
    assert sorted(jw) == sorted(tw)
    for k in jw:
        if isinstance(jw[k], tuple):
            assert isinstance(tw[k], tuple), k
            same_array(jw[k][0], tw[k][0], k)
            same_array(jw[k][1], tw[k][1], k + ".scales")
        else:
            same_array(jw[k], tw[k], k)


def same_tokenizer(jt, tt):
    assert jt.index_texts == tt.index_texts
    assert jt.show_texts == tt.show_texts
    assert np.asarray(jt.scores, np.float32).tobytes() == \
        np.asarray(tt.scores, np.float32).tobytes()
    assert [int(t) for t in jt.types] == [int(t) for t in tt.types]
    assert (jt.bos_token_id, jt.eos_token_id, jt.pad_token_id,
            jt.conn_tag, int(jt.vocab_type)) == \
        (tt.bos_token_id, tt.eos_token_id, tt.pad_token_id, tt.conn_tag,
         int(tt.vocab_type))


def leaf_np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def same_params(jp, tp):
    for f in dataclasses.fields(jp):
        a, b = getattr(jp, f.name), getattr(tp, f.name)
        if hasattr(a, "scales"):
            assert (a.qtype.value, a.group_size, a.group_axis, a.packed) == \
                (b.qtype.value, b.group_size, b.group_axis, b.packed), f.name
            same_array(leaf_np(a.data), leaf_np(b.data), f.name)
            same_array(leaf_np(a.scales), leaf_np(b.scales), f.name)
        else:
            same_array(leaf_np(a), leaf_np(b), f.name)


# -- files -------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One file of each format from one set of seeded fp32 weights."""
    d = tmp_path_factory.mktemp("ckpts")
    w = jsyn.tiny_weights(TINY, seed=1)
    tok = jsyn.tiny_tokenizer(TINY.vocab_size)
    out = {}
    ck, tk = jsyn.write_tiny_llama2c(str(d / "l2c"), TINY, seed=1)
    out["llama2c"] = (ck, tk, jreg.FileType.LLAMA2C)
    for qt in ("INT8", "INT16", "INT4", "NONE"):
        p = str(d / f"m_{qt}.flm")
        jflm.write_flm(p, TINY, tok, w, jcfg.QuantType[qt],
                       rope_convention="interleaved")
        out["flm_" + qt] = (p, "", jreg.FileType.UNKNOWN)
    p = str(d / "m.gguf")
    write_gguf(p, TINY, w, tok, f16=("wv",))
    out["gguf"] = (p, "", jreg.FileType.UNKNOWN)
    out["hf_bin"] = (write_hf(str(d / "hf_bin"), TINY, w, tok), "",
                     jreg.FileType.UNKNOWN)
    out["hf_st"] = (write_hf(str(d / "hf_st"), TINY, w, tok,
                             shard="safetensors"), "", jreg.FileType.UNKNOWN)
    return out


FORMATS = ["llama2c", "flm_INT8", "flm_INT16", "flm_INT4", "flm_NONE",
           "gguf", "hf_bin", "hf_st"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_load_model_matches_jax(files, fmt):
    path, tok, ft = files[fmt]
    jm = jreg.load_model(path, tok, ft)
    tm = treg.load_model(path, tok, treg.FileType(ft.value))
    assert jm.file_type.value == tm.file_type.value
    same_config(jm.config, tm.config)
    same_weights(jm.weights, tm.weights)
    same_tokenizer(jm.tokenizer, tm.tokenizer)
    # tokenizer-only loads read no weights
    tm2 = treg.load_model(path, tok, treg.FileType(ft.value),
                          tokenizer_only=True)
    assert not tm2.weights
    same_tokenizer(jm.tokenizer, tm2.tokenizer)


@pytest.mark.parametrize("fmt,qtype", [
    ("llama2c", "NONE"), ("llama2c", "INT8"), ("llama2c", "INT16"),
    ("llama2c", "INT4"), ("flm_INT8", None), ("flm_INT4", None),
    ("gguf", None), ("hf_st", "INT8")])
def test_build_matches_jax(files, fmt, qtype):
    """``LoadedModel.build`` on the same file: every leaf bit-equal, the
    INT4 build padded from hidden 128 to 512 (int8-held: the padded
    extent does not pack at dim 64)."""
    path, tok, ft = files[fmt]
    jm = jreg.load_model(path, tok, ft)
    tm = treg.load_model(path, tok, treg.FileType(ft.value))
    jq = None if qtype is None else jcfg.QuantType[qtype]
    tq = None if qtype is None else tcfg.QuantType[qtype]
    jp = jm.build(jq)
    tp = tm.build(tq, device="cpu")
    same_config(jm.config, tm.config)
    same_params(jp, tp)
    if qtype == "INT4":
        assert tm.config.hidden_dim == 512 and tp.w2.shape[-2] == 512


@pytest.mark.parametrize("qtype", ["NONE", "INT8", "INT16", "INT4"])
def test_build_params_matches_jax(qtype):
    """``build_params`` on in-memory arrays at a width where INT4 packs:
    fp32 arrays quantized on load, and pre-quantized pairs."""
    w = jsyn.tiny_weights(WIDE, seed=2)
    jq, tq = jcfg.QuantType[qtype], tcfg.QuantType[qtype]
    tc = tcfg_of(WIDE)
    jp = jl.build_params(WIDE, w, jq)
    tp = tl.build_params(tc, w, tq, device="cpu")
    same_params(jp, tp)
    if qtype == "INT4":
        assert tp.wq.packed and tp.w2.packed
    if qtype in ("INT8", "INT16"):
        pre = dict(w, wo=jgq.quantize_np(w["wo"], jq, 64))
        same_params(jl.build_params(WIDE, pre, jq),
                    tl.build_params(tc, pre, tq, device="cpu"))


@pytest.mark.parametrize("qtype", ["INT8", "INT4", "INT16", "NONE"])
def test_write_flm_bytes_match_jax(tmp_path, qtype):
    """The same bytes as JAX's ``write_flm``, from numpy and from torch
    tensors given one layer at a time."""
    w = jsyn.tiny_weights(TINY, seed=3)
    tok = jsyn.tiny_tokenizer(TINY.vocab_size)
    jpath, tpath, tpath2 = (str(tmp_path / n) for n in ("j", "t", "t2"))
    jflm.write_flm(jpath, TINY, tok, w, jcfg.QuantType[qtype])
    tc = tcfg_of(TINY)
    ttok = tsyn.tiny_tokenizer(TINY.vocab_size)
    tflm.write_flm(tpath, tc, ttok, w, tcfg.QuantType[qtype])

    class Layers:
        def __init__(self, a):
            self.a = a

        def __getitem__(self, l):
            return torch.from_numpy(self.a[l].copy())

    lazy = {k: (Layers(v) if v.ndim > 1 and k not in ("embedding",
                                                      "classifier")
                else torch.from_numpy(v.copy())) for k, v in w.items()}
    lazy["attn_norm"] = Layers(w["attn_norm"])
    lazy["ffn_norm"] = Layers(w["ffn_norm"])
    tflm.write_flm(tpath2, tc, ttok, lazy, tcfg.QuantType[qtype])
    want = open(jpath, "rb").read()
    assert open(tpath, "rb").read() == want
    assert open(tpath2, "rb").read() == want


def test_detect_file_type(files, tmp_path):
    for fmt, want in (("flm_INT8", "FLM"), ("flm_INT4", "FLM"),
                      ("gguf", "GGUF"), ("hf_bin", "HF"), ("hf_st", "HF"),
                      ("llama2c", "UNKNOWN")):
        path = files[fmt][0]
        assert treg.detect_file_type(path).name == want
        assert jreg.detect_file_type(path).name == want
    # llama2c is sniffed only at plausible dimensions
    big = TINY.replace(dim=512, hidden_dim=512, n_layers=1, n_heads=8,
                       n_kv_heads=8, vocab_size=1000, max_seq_len=16)
    from fastllama_tpu_torch.loaders.llama2c import write_llama2c
    p = str(tmp_path / "big.bin")
    write_llama2c(p, tcfg_of(big), jsyn.tiny_weights(big))
    assert treg.detect_file_type(p).name == "LLAMA2C"
    assert jreg.detect_file_type(p).name == "LLAMA2C"
    with pytest.raises(ValueError, match="cannot detect"):
        treg.load_model(str(tmp_path / "nothing"))
    for name in ("flm", "gguf", "llama2c", "hf", ""):
        assert treg.FileType.parse(name).value == \
            jreg.FileType.parse(name).value


def test_gguf_q8_0_gives_int8_at_group_32(files, tmp_path):
    """``Q8_0`` tensors load as INT8 at group size 32, the leaves equal
    what the bytes encode (deinterleaved for Wq/Wk), F16 as f32."""
    w = jsyn.tiny_weights(TINY, seed=1)
    tok = jsyn.tiny_tokenizer(TINY.vocab_size)
    expect = write_gguf(str(tmp_path / "x.gguf"), TINY, w, tok,
                        f16=("wv",))
    m = treg.load_model(str(tmp_path / "x.gguf"))
    assert m.config.quant_type == tcfg.QuantType.INT8
    assert m.config.group_size == 32
    hs = TINY.head_size
    for f, pairs in expect.items():
        data = np.stack([q for q, _ in pairs]) if len(pairs) > 1 \
            else pairs[0][0]
        scales = np.stack([s for _, s in pairs]) if len(pairs) > 1 \
            else pairs[0][1]
        if f in ("wq", "wk"):
            data = trope.deinterleave_heads(data, hs)
            scales = trope.deinterleave_heads(scales, hs)
        same_array(m.weights[f][0], data, f)
        same_array(m.weights[f][1], scales, f)
    same_array(m.weights["wv"], w["wv"].astype(np.float16).astype(
        np.float32), "wv")
    p = m.build(device="cpu")
    assert p.wq.group_size == 32 and p.wq.data.dtype == torch.int8
    assert p.embedding.group_size == 32


def test_hf_rope_scaling_parse_matches_jax():
    base = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, vocab_size=256,
                max_position_embeddings=512)
    for rs in (None, {"type": "linear", "factor": 4.0},
               {"rope_type": "yarn", "factor": 2.0,
                "original_max_position_embeddings": 256},
               {"rope_type": "yarn", "factor": 4.0,
                "attention_factor": 1.3,
                "original_max_position_embeddings": 128},
               {"rope_type": "llama3", "factor": 8.0}):
        d = dict(base, rope_scaling=rs, num_key_value_heads=2,
                 rope_theta=5e5, _name_or_path="tiny")
        same_config(jhf._config_from_json(dict(d)),
                    thf._config_from_json(dict(d)))


def test_safetensors_reader_matches_package(tmp_path):
    """Files written by ``safetensors.numpy.save_file`` read back to the
    package's own arrays, dtype for dtype; a dtype the reader does not
    read raises with its name."""
    from safetensors import safe_open
    from safetensors.numpy import save_file
    rng = np.random.default_rng(4)
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "f64": rng.normal(size=(2, 2)).astype(np.float64),
              "i8": rng.integers(-128, 127, (4, 4)).astype(np.int8),
              "i32": rng.integers(-9, 9, (6,)).astype(np.int32),
              "i64": rng.integers(-9, 9, (1, 3)).astype(np.int64),
              "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
              "b": rng.integers(0, 2, (3,)).astype(bool),
              "scalar": np.asarray(2.5, np.float32)}
    p = str(tmp_path / "a.safetensors")
    save_file(arrays, p, metadata={"format": "np"})
    got = thf.read_safetensors(p)
    with safe_open(p, framework="np") as f:
        assert sorted(got) == sorted(f.keys())
        for k in f.keys():
            same_array(f.get_tensor(k), got[k], k)
    # a bfloat16 tensor: its header by hand
    h = json.dumps({"x": {"dtype": "BF16", "shape": [2],
                          "data_offsets": [0, 4]}}).encode()
    q = str(tmp_path / "bf16.safetensors")
    with open(q, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"\0" * 4)
    with pytest.raises(ValueError, match="BF16"):
        thf.read_safetensors(q)


@pytest.mark.parametrize("qtype", ["INT16", "INT8", "INT4"])
def test_numpy_helpers_match_jax(qtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(3, 128, 256)) * 0.1).astype(np.float32)
    x[0, 0, :64] = 0.0                      # an all-zero group
    jq, tq = jcfg.QuantType[qtype], tcfg.QuantType[qtype]
    for gs in (32, 64):
        jd, js = jgq.quantize_np(x, jq, gs)
        td, ts = tgq.quantize_np(x, tq, gs)
        same_array(jd, td)
        same_array(js, ts)
        same_array(jgq.dequantize_np(jd, js, gs),
                   tgq.dequantize_np(td, ts, gs))
        # the torch quantize gives the same bits
        q = tgq.quantize(torch.from_numpy(x), tq, gs)
        same_array(td, q.data.numpy())
        same_array(ts, q.scales.numpy())
        for a, b in zip(jgq.transpose_weight(jd, js),
                        tgq.transpose_weight(td, ts)):
            same_array(a, b)
    v = rng.integers(-8, 8, size=(2, 64, 128)).astype(np.int8)
    same_array(jgq.pack_int4_np(v), tgq.pack_int4_np(v))
    same_array(jgq.unpack_int4_np(jgq.pack_int4_np(v)),
               tgq.unpack_int4_np(tgq.pack_int4_np(v)))
    same_array(tgq.unpack_int4_np(tgq.pack_int4_np(v)), v)
    same_array(jgq.pack_int4_rows_np(v), tgq.pack_int4_rows_np(v))
    same_array(jgq.unpack_int4_rows_np(jgq.pack_int4_rows_np(v)),
               tgq.unpack_int4_rows_np(tgq.pack_int4_rows_np(v)))
    same_array(tgq.pack_int4_rows(torch.from_numpy(v)).numpy(),
               tgq.pack_int4_rows_np(v))
    fq = tgq.from_prequantized(td, ts, tq, 64, device="cpu")
    same_array(fq.data.numpy(), td)


def test_rope_helpers_match_jax():
    """The deinterleave permutation bit-equal; interleaved RoPE within
    1e-6 of JAX's (elementwise f32 products; XLA may fuse them)."""
    import jax.numpy as jnp
    for hs in (8, 64, 128):
        same_array(jrope.deinterleave_perm(hs), trope.deinterleave_perm(hs))
    w = np.random.default_rng(6).normal(size=(2, 4 * 16, 32)).astype(
        np.float32)
    same_array(jrope.deinterleave_heads(w, 16),
               trope.deinterleave_heads(w, 16))
    x = np.random.default_rng(7).normal(size=(5, 4, 16)).astype(np.float32)
    ang = np.random.default_rng(8).normal(size=(5, 1, 8)).astype(np.float32)
    want = np.asarray(jrope.apply_rope_interleaved(
        jnp.asarray(x), jnp.cos(ang), jnp.sin(ang)))
    got = trope.apply_rope_interleaved(torch.from_numpy(x),
                                       torch.from_numpy(np.cos(ang)),
                                       torch.from_numpy(np.sin(ang)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_pad_hidden_matches_jax():
    w = jsyn.tiny_weights(TINY, seed=9)
    pre = dict(w)
    for k in ("w1", "w3", "w2"):
        pre[k] = jgq.quantize_np(w[k], jcfg.QuantType.INT8, 64)
    for src in (w, pre):
        jw, tw = dict(src), dict(src)
        jc = jsh.pad_hidden_for_sharding(TINY, jw, 4)
        tc = tsh.pad_hidden_for_sharding(tcfg_of(TINY), tw, 4)
        same_config(jc, tc)
        assert tc.hidden_dim == 256
        same_weights(jw, tw)
    assert tsh.pad_hidden_for_sharding(tcfg_of(TINY), dict(w), 1) == \
        tcfg_of(TINY)


def test_llama2c_tokenizer_roundtrip(files, tmp_path):
    """The port's llama2c writers give the JAX writers' bytes."""
    from fastllama_tpu.loaders import llama2c as jl2
    from fastllama_tpu_torch.loaders import llama2c as tl2
    w = jsyn.tiny_weights(TINY, seed=1)
    for shared in (True, False):
        jl2.write_llama2c(str(tmp_path / "j"), TINY, w, shared)
        tl2.write_llama2c(str(tmp_path / "t"), tcfg_of(TINY), w, shared)
        assert open(tmp_path / "j", "rb").read() == \
            open(tmp_path / "t", "rb").read()
    jl2.write_llama2c_tokenizer(str(tmp_path / "jt"),
                                jsyn.tiny_tokenizer(TINY.vocab_size))
    tl2.write_llama2c_tokenizer(str(tmp_path / "tt"),
                                tsyn.tiny_tokenizer(TINY.vocab_size))
    assert open(tmp_path / "jt", "rb").read() == \
        open(tmp_path / "tt", "rb").read()
    assert os.path.getsize(files["llama2c"][0]) > 0
