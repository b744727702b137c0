"""SPM/BPE tokenizer with the reference's exact encode/decode semantics.

Re-implements the C++ engine's ``cpuft::Tokenizer`` (its
``src/transformer/tokenizer.{h,cpp}``):

* encode (tokenizer.cpp:247-327): optional BOS; UTF-8 chunking of the input
  (single codepoints looked up whole); unknown chunks fall back to byte
  tokens at ``byte+3``; a lone space maps to the "▁" token; then a greedy
  merge loop that repeatedly joins the adjacent pair whose concatenation
  exists in the vocab with the highest score.
* decode (tokenizer.cpp:329-398): show-text with "▁"→" ", leading-space strip
  after BOS, ``<0xXX>`` byte pieces, unsafe single-byte filter.

The port's own copy of ``fastllama_tpu/loaders/tokenizer.py``.  A C++
fast path for the merge loop (``loaders/native.py``, ctypes-loaded from
the repo's ``csrc/ftl_native.cpp``) is used where the host can build it;
this file is the always-available pure-Python implementation and the
golden reference for it.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

CONN_TAG = "▁"  # ▁


class VocabType:
    NONE = 0
    BPE = 1
    SPM = 2


class TokenType:
    UNKNOWN = 0
    NORMAL = 1
    CONTROL = 2
    BYTE = 3
    USER_DEFINED = 4
    UNUSED = 5


@dataclass
class Tokenizer:
    vocab_type: int = VocabType.BPE
    index_texts: List[str] = field(default_factory=list)
    show_texts: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    bos_token_id: int = 1       # tokenizer.h:142 default
    eos_token_id: int = 2
    pad_token_id: int = -1
    conn_tag: str = CONN_TAG
    _text2id: Dict[str, int] = field(default_factory=dict, repr=False)
    _underline_id: int = -1

    @property
    def vocab_size(self) -> int:
        return len(self.index_texts)

    # -- construction -------------------------------------------------------

    def finalize(self) -> "Tokenizer":
        """Build lookup structures (build_text2id_map, tokenizer.cpp:142-160)
        and show-texts (set_token_texts, tokenizer.cpp:106-116)."""
        if not self.show_texts:
            self.show_texts = [
                " " + t[len(self.conn_tag):] if t.startswith(self.conn_tag) else t
                for t in self.index_texts]
        if not self.scores:
            self.scores = [0.0] * self.vocab_size
        if not self.types:
            self.types = [TokenType.NORMAL] * self.vocab_size
        self._text2id = {}
        for i, t in enumerate(self.index_texts):
            self._text2id[t] = i
        # C++ inserts in order and operator[] overwrites, so LAST duplicate
        # wins — match dict semantics above (same behaviour).
        self._underline_id = self._text2id.get(self.conn_tag, -1)
        # native fast path for the greedy merge loop; falls back to the
        # pure-Python encode below when unavailable
        self._native = None
        try:
            from fastllama_tpu_torch.loaders.native import NativeEncoder
            self._native = NativeEncoder(self.index_texts, self.scores,
                                         self.bos_token_id, self.conn_tag)
        except Exception:
            self._native = None
        return self

    @staticmethod
    def from_llama2c_bin(path: str, vocab_size: int) -> "Tokenizer":
        """Karpathy llama2.c ``tokenizer.bin``: i32 max_token_length then
        vocab_size x (f32 score, i32 len, bytes) (tokenizer.cpp:162-234)."""
        tk = Tokenizer(vocab_type=VocabType.BPE)
        with open(path, "rb") as f:
            struct.unpack("<i", f.read(4))  # max_token_length, unused here
            for _ in range(vocab_size):
                (score,) = struct.unpack("<f", f.read(4))
                (ln,) = struct.unpack("<i", f.read(4))
                text = f.read(ln).decode("utf-8", errors="replace")
                tk.index_texts.append(text)
                tk.scores.append(score)
        # llama2.c stores pieces with raw leading spaces, not ▁: show = index
        tk.show_texts = list(tk.index_texts)
        # the reference's .bin path never sets _conn_tag (an empty
        # string_view, tokenizer.h:147) so no " " -> ▁ mapping exists there
        # (set_vocab's "▁" default applies to FLM/GGUF only,
        # tokenizer.cpp:74-75) — verified against the compiled reference
        tk.conn_tag = ""
        return tk.finalize()

    # -- encode -------------------------------------------------------------

    def _search_text(self, text: str) -> int:
        # tokenizer.cpp:236-239: a lone space resolves to the ▁ token —
        # UNCONDITIONALLY, so with no conn tag (.bin vocabs) a lone space
        # byte-fallbacks even if a literal " " piece exists
        if text == " ":
            return self._underline_id
        return self._text2id.get(text, -1)

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False
               ) -> List[int]:
        if not text:
            return []
        if getattr(self, "_native", None) is not None:
            try:
                tokens = self._native.encode(text, add_bos)
                if add_eos:
                    tokens.append(self.eos_token_id)
                return tokens
            except Exception:
                pass  # fall through to the Python reference implementation
        tokens: List[int] = []
        if add_bos:
            tokens.append(self.bos_token_id)

        # UTF-8 chunking with byte fallback (+3) — tokenizer.cpp:272-294
        raw = text.encode("utf-8")
        i = 0
        while i < len(raw):
            n = 1
            # gather continuation bytes, up to 4 total (slen < 4 guard)
            while i + n < len(raw) and (raw[i + n] & 0xC0) == 0x80 and n < 4:
                n += 1
            chunk = raw[i:i + n]
            try:
                # strict: an invalid byte must byte-fallback, not collapse
                # to U+FFFD and collide with a replacement-char piece
                tid = self._search_text(chunk.decode("utf-8"))
            except UnicodeDecodeError:
                tid = -1
            if tid >= 0:
                tokens.append(tid)
            else:
                tokens.extend(b + 3 for b in chunk)
            i += n

        # greedy highest-score merge — tokenizer.cpp:296-320
        while True:
            best_score, best_id, best_idx = -1e10, -1, -1
            for j in range(len(tokens) - 1):
                merged = self.index_texts[tokens[j]] + self.index_texts[tokens[j + 1]]
                tid = self._search_text(merged)
                if tid != -1 and self.scores[tid] > best_score:
                    best_score, best_id, best_idx = self.scores[tid], tid, j
            if best_idx == -1:
                break
            tokens[best_idx:best_idx + 2] = [best_id]

        if add_eos:
            tokens.append(self.eos_token_id)
        return tokens

    # -- decode -------------------------------------------------------------

    @staticmethod
    def _is_safe_piece(piece: str) -> bool:
        # tokenizer.cpp:387-398: filter lone non-printable raw bytes
        if not piece:
            return False
        if len(piece) == 1:
            o = ord(piece)
            if o > 255:
                return True
            return piece.isprintable() or piece.isspace()
        return True

    def byte_value(self, token: int) -> Optional[int]:
        """The raw byte of a ``<0xXX>`` byte-fallback token, else None."""
        if token < 0 or token >= self.vocab_size:
            return None
        piece = self.show_texts[token]
        if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
            try:
                return int(piece[3:5], 16)
            except ValueError:
                return None
        return None

    def decode_one(self, token: int, prev_token: int = -1) -> str:
        """Stateless per-token piece.  Byte-fallback tokens come back as a
        single chr(); a LONE high byte of a multi-byte UTF-8 sequence cannot
        be rendered statelessly — use :class:`StreamDecoder` for streaming
        (the reference writes raw bytes and lets the terminal assemble
        them, tokenizer.cpp:337-341)."""
        if token < 0 or token >= self.vocab_size:
            return ""
        piece = self.show_texts[token]
        if prev_token == self.bos_token_id and piece.startswith(" "):
            piece = piece[1:]
        b = self.byte_value(token)
        if b is not None:
            piece = chr(b)
        return piece if self._is_safe_piece(piece) else ""

    def decode(self, tokens: Sequence[int]) -> str:
        """Byte-level assembly: byte-fallback tokens contribute raw bytes so
        multi-byte UTF-8 reassembles correctly (the reference's per-piece
        C-locale isprint filter drops such bytes — a known lossy corner we
        deliberately improve on)."""
        out = bytearray()
        prev = -1
        for t in tokens:
            b = self.byte_value(t)
            if b is not None:
                out += bytes([b])
            else:
                out += self.decode_one(t, prev).encode("utf-8")
            prev = t
        return out.decode("utf-8", errors="replace")


class StreamDecoder:
    """Incremental detokenizer for streaming callbacks: byte-fallback tokens
    feed a UTF-8 incremental decoder so multi-byte sequences flush as proper
    text (a stateless per-token decode can only mojibake or drop the high
    bytes).  One instance per generation."""

    def __init__(self, tokenizer: "Tokenizer"):
        import codecs
        self.tk = tokenizer
        self._dec = codecs.getincrementaldecoder("utf-8")("replace")

    def piece(self, token: int, prev_token: int = -1) -> str:
        b = self.tk.byte_value(token)
        if b is not None:
            return self._dec.decode(bytes([b]), False)
        return self._dec.decode(b"", True) + self.tk.decode_one(token,
                                                                prev_token)

    def flush(self) -> str:
        """Drain any incomplete trailing sequence (end of generation)."""
        return self._dec.decode(b"", True)


def build_byte_fallback_vocab(extra: Optional[List[str]] = None) -> Tokenizer:
    """Tiny synthetic vocab for tests: BOS/EOS/UNK + 256 byte tokens (+3
    offset, mirroring the llama byte-fallback layout) + optional merge
    entries."""
    tk = Tokenizer()
    tk.index_texts = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    tk.scores = [0.0] * len(tk.index_texts)
    tk.types = ([TokenType.UNKNOWN, TokenType.CONTROL, TokenType.CONTROL]
                + [TokenType.BYTE] * 256)
    if extra:
        for j, piece in enumerate(extra):
            tk.index_texts.append(piece)
            tk.scores.append(float(j + 1))
            tk.types.append(TokenType.NORMAL)
    return tk.finalize()
