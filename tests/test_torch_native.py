"""The native C++ encoder behind the port's tokenizer (``loaders/native``,
built from the repo's ``csrc/ftl_native.cpp``) against the pure-Python
path: the JAX package's ``tests/test_native.py`` cases on the port's
tokenizer.  Skips where the host cannot build the library."""
import random

import pytest

from fastllama_tpu_torch.loaders import native
from fastllama_tpu_torch.tools.synthetic import tiny_tokenizer

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the native tokenizer library "
                                       "cannot be built on this host")

TEXTS = [
    "the cat", "the dog and the boy", " ", "a", "",
    "the story of the cat and the dog",
    "unknownwords zzz qqq", "mixed 123 !@# text",
    "é中文 bytes", "the the the the",
]


def test_native_matches_python():
    tk = tiny_tokenizer()
    assert tk._native is not None
    nat_enc = tk._native
    tk._native = None               # the Python path for comparison
    for text in TEXTS:
        if not text:
            continue
        for bos in (True, False):
            assert nat_enc.encode(text, add_bos=bos) == \
                tk.encode(text, add_bos=bos), text
    # the library lives under the checkout's git-ignored build directory
    assert native.library_path().is_file()
    assert native.library_path().parts[-4:-2] == ("build", "native")


def test_native_speedup_sanity():
    tk = tiny_tokenizer()
    nat_enc = tk._native
    tk._native = None
    text = "the story of the cat and the dog and the boy " * 20
    assert nat_enc.encode(text) == tk.encode(text)


def test_native_python_encode_fuzz():
    """Token for token on randomized inputs (ASCII, unicode, byte
    fallback, long merges), with and without BOS and EOS."""
    tk = tiny_tokenizer(512)
    rng = random.Random(0)
    corpus = ["the", "cat", "sat", "on", "a", "mat", " ", "é", "日", "🌍",
              "\n", "\t", "x" * 50, "<0x41>", "▁the", "''", "\\"]
    for trial in range(200):
        text = "".join(rng.choices(corpus, k=rng.randint(1, 12)))
        bos, eos = bool(trial % 2), bool(trial % 3 == 0)
        got = tk.encode(text, add_bos=bos, add_eos=eos)
        saved, tk._native = tk._native, None
        want = tk.encode(text, add_bos=bos, add_eos=eos)
        tk._native = saved
        assert got == want, (text, got, want)
