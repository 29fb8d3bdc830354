"""The checkpoint's Qwen2 byte-level BPE tokenizer, read from ``tokenizer.json``
or from ``vocab.json`` + ``merges.txt``.

Counterpart of what the JAX package's ``models/qwen_vl.py::load_hf_tokenizer``
returns for a Qwen2 / Qwen2.5-VL checkpoint (``transformers``'
``Qwen2TokenizerFast`` over the ``tokenizers`` library), in plain Python: the
card host has neither library, nor ``regex``. ``encode`` gives the ids that
``tok.encode(text, add_special_tokens=False)`` gives there.

It reads exactly the components a Qwen2.5-VL ``tokenizer.json`` uses and
raises a ``ValueError`` naming anything else:

- ``added_tokens``, matched leftmost-longest in the raw text first (all of
  them ``normalized: false``; ``lstrip``, ``rstrip`` and ``single_word``
  false), as ``tokenizers``' added vocabulary matches them;
- the ``NFC`` normalizer, on the text between added tokens;
- the pre-tokenizer: ``Split`` on Qwen2's pattern (:data:`QWEN2_PATTERN`,
  ``Isolated``), matched by :func:`pre_tokenize`, a scanner written for this
  one pattern, then ``ByteLevel`` without prefix space or regex: each piece's
  UTF-8 bytes through GPT-2's byte-to-unicode table;
- the ``BPE`` model: merges by rank, lowest first and leftmost among equals,
  merges given as ``"a b"`` strings or ``["a", "b"]`` pairs, ``ignore_merges``
  honoured; no byte fallback, dropout, subword prefix or word suffix;
- a ``ByteLevel`` (or no) post-processor, which adds nothing either way.

Beside ``tokenizer.json``, a ``tokenizer_config.json`` with an
``added_tokens_decoder`` is held against the file's added tokens.

A checkpoint saved in the older layout has no ``tokenizer.json``, only
``vocab.json`` and ``merges.txt`` (:func:`from_slow_files`). From them the
tokenizer is built as ``transformers``' ``Qwen2Converter`` builds its fast
tokenizer: the merges in file order after the ``#version`` line (blank lines
skipped, a repeated merge keeping its first rank), the normalizer, Split,
ByteLevel and BPE above; the added tokens from ``tokenizer_config.json``'s
``added_tokens_decoder``, else from ``added_tokens.json`` (special where the
config or ``special_tokens_map.json`` names them, the others
``normalized``), then the named special tokens not yet among them; each
given the id ``tokenizers`` gives it as it is added in id order (the
vocabulary's own id, else the next one past the vocabulary).

An added token marked ``normalized`` is matched after the others, in the NFC
form of the text between them, as ``tokenizers`` matches it.

The scanner's character classes are those of the regex engine ``tokenizers``
runs (Oniguruma): ``\\s`` is Unicode White_Space (not Python's ``isspace``,
which also takes U+001C–U+001F), ``\\p{L}`` and ``\\p{N}`` every ``L*`` and
``N*`` category of Python's ``unicodedata``, and the contractions' ``(?i:...)``
folds ``ſ`` (U+017F) to ``s``. Where the two Unicode tables' versions assign a
code point differently the two sides may split it differently.
"""

from __future__ import annotations

import heapq
import json
import os
import unicodedata
from typing import Dict, List, Optional, Tuple

# the Split pattern of every Qwen2 / Qwen2.5 tokenizer.json
QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

# Unicode White_Space: Oniguruma's \s
WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004"
                       "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f"
                       "\u3000")
# (?i:'s|'t|'re|'ve|'m|'ll|'d) in order, each letter with its case folds
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")
_FOLD = {"S": "s", "ſ": "s", "T": "t", "R": "r", "E": "e", "V": "v", "M": "m",
         "L": "l", "D": "d"}
_CACHE_ENTRIES = 100_000


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte → printable character table (the ByteLevel alphabet)."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    chars, extra = {}, 0
    for b in range(256):
        if b in keep:
            chars[b] = chr(b)
        else:
            chars[b] = chr(256 + extra)
            extra += 1
    return chars


BYTE_CHARS = bytes_to_unicode()


def _kind(c: str) -> str:
    """'L', 'N', 's' (White_Space) or 'o' for one character."""
    cat = unicodedata.category(c)[0]
    if cat in "LN":
        return cat
    return "s" if c in WHITESPACE else "o"


def _match(s: str, kinds: str, i: int) -> int:
    """End of the match of :data:`QWEN2_PATTERN` at ``i``, its alternatives
    tried in order (every character starts one)."""
    n = len(s)
    c, k = s[i], kinds[i]
    if c == "'":  # (?i:'s|'t|'re|'ve|'m|'ll|'d)
        for alt in _CONTRACTIONS:
            end = i + 1 + len(alt)
            if end <= n and "".join(_FOLD.get(x, x) for x in s[i + 1:end]) == alt:
                return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    j = i if k == "L" else (i + 1 if c not in "\r\n" and k != "N" and i + 1 < n
                            and kinds[i + 1] == "L" else -1)
    if j >= 0:
        while j < n and kinds[j] == "L":
            j += 1
        return j
    if k == "N":  # \p{N}
        return i + 1
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    j = i + 1 if c == " " else i
    if j < n and kinds[j] == "o":
        while j < n and kinds[j] == "o":
            j += 1
        while j < n and s[j] in "\r\n":
            j += 1
        return j
    # the rest start at whitespace: its run is s[i:j]
    j = i
    while j < n and kinds[j] == "s":
        j += 1
    # \s*[\r\n]+ : through the run's last line break
    last = max(s.rfind("\r", i, j), s.rfind("\n", i, j))
    if last >= 0:
        return last + 1
    # \s+(?!\S) : the whole run at the end of the text, else all but its last
    if j == n:
        return j
    if j - i >= 2:
        return j - 1
    return j  # \s+


def pre_tokenize(text: str) -> List[str]:
    """``text`` split as ``Split(QWEN2_PATTERN, "isolated")`` splits it."""
    kinds = "".join(_kind(c) for c in text)
    out, i = [], 0
    while i < len(text):
        j = _match(text, kinds, i)
        out.append(text[i:j])
        i = j
    return out


def _refuse(what: str) -> None:
    raise ValueError(f"unsupported tokenizer.json: {what}")


def _first_chars(patterns: Dict[str, int]) -> Dict[str, List[str]]:
    """{first character: the patterns starting with it, longest first}."""
    out: Dict[str, List[str]] = {}
    for t in sorted(patterns, key=len, reverse=True):
        out.setdefault(t[0], []).append(t)
    return out


def _split(text: str, patterns: Dict[str, int], first: Dict[str, List[str]]
           ) -> List[Tuple[str, Optional[int]]]:
    """``text`` cut at its matches of ``patterns``, leftmost then longest:
    (piece, the pattern's id or None) in order."""
    out, start, i, n = [], 0, 0, len(text)
    while i < n:
        hit = None
        for t in first.get(text[i], ()):
            if text.startswith(t, i):
                hit = t
                break
        if hit is None:
            i += 1
            continue
        if start < i:
            out.append((text[start:i], None))
        out.append((hit, patterns[hit]))
        i = start = i + len(hit)
    if start < n:
        out.append((text[start:], None))
    return out


def files_in(path: str) -> Optional[str]:
    """Which tokenizer a checkpoint directory holds: ``"json"``
    (``tokenizer.json``), ``"slow"`` (``vocab.json`` + ``merges.txt``) or
    None."""
    if os.path.isfile(os.path.join(path, "tokenizer.json")):
        return "json"
    if all(os.path.isfile(os.path.join(path, f)) for f in SLOW_FILES):
        return "slow"
    return None


SLOW_FILES = ("vocab.json", "merges.txt")
# transformers' special-token attributes, in its SPECIAL_TOKENS_ATTRIBUTES order
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token", "additional_special_tokens")
# Qwen2TokenizerFast's special tokens where the config names none
_QWEN2_SPECIAL = {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                  "pad_token": "<|endoftext|>"}
# tokenizer_config.json settings that leave Qwen2's encoding as it is
_CONFIG_KEYS = frozenset(_SPECIAL_KEYS) | {
    "added_tokens_decoder", "add_prefix_space", "split_special_tokens", "tokenizer_class",
    "errors", "clean_up_tokenization_spaces", "model_max_length", "chat_template",
    "extra_special_tokens", "padding_side", "truncation_side", "model_input_names",
    "processor_class", "auto_map", "name_or_path", "special_tokens_map_file",
    "tokenizer_file", "vocab_file", "merges_file", "add_bos_token", "add_eos_token",
    "max_length", "stride", "truncation_strategy", "pad_to_multiple_of", "pad_token_type_id",
    "use_default_system_prompt", "verbose", "spaces_between_special_tokens"}
_QWEN2_CLASSES = (None, "Qwen2Tokenizer", "Qwen2TokenizerFast")


def _read_json(path: str, default=None):
    if not os.path.isfile(path):
        return default
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_text(tok) -> Optional[str]:
    """A special token as a config names it: a string or an AddedToken dict."""
    return tok.get("content") if isinstance(tok, dict) else tok


def from_slow_files(path: str) -> dict:
    """The ``tokenizer.json`` spec that ``transformers`` builds from the slow
    files in ``path`` (see the module docstring), with its added tokens at
    the ids ``tokenizers`` assigns them."""
    def refuse(what: str) -> None:
        raise ValueError(f"unsupported tokenizer files in {path}: {what}")

    vocab = _read_json(os.path.join(path, "vocab.json"))
    if not isinstance(vocab, dict) or not all(isinstance(v, int) for v in vocab.values()):
        refuse("vocab.json is not a {token: id} object")
    with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
        lines = [line.strip() for line in f.read().split("\n")]
    if lines and lines[0].startswith("#version:"):
        lines[0] = ""
    pairs = [tuple(line.split()) for line in lines if line]
    if any(len(pair) != 2 for pair in pairs):
        i = next(i for i, line in enumerate(lines) if line and len(line.split()) != 2)
        refuse(f"merges.txt line {i + 1} {lines[i]!r} is not two tokens")
    merges = list(dict.fromkeys(pairs))  # a repeated merge keeps its first rank
    config = _read_json(os.path.join(path, "tokenizer_config.json"), {})
    unknown = sorted(set(config) - _CONFIG_KEYS)
    if unknown:
        refuse(f"tokenizer_config.json sets {unknown}")
    if config.get("tokenizer_class") not in _QWEN2_CLASSES:
        refuse(f"tokenizer_class {config['tokenizer_class']!r} (Qwen2's is Qwen2Tokenizer)")
    for flag in ("add_prefix_space", "split_special_tokens", "add_bos_token", "add_eos_token"):
        if config.get(flag):
            refuse(f"tokenizer_config.json {flag}: true")

    # transformers' _from_pretrained: the config's added_tokens_decoder, else
    # added_tokens.json with special_tokens_map.json merged into the config
    entries = []  # (given id, AddedToken fields)
    if "added_tokens_decoder" in config:
        for k, tok in config["added_tokens_decoder"].items():
            extra = sorted(set(tok) - {"content", "lstrip", "rstrip", "normalized",
                                       "single_word", "special", "__type"})
            if extra:
                refuse(f"added token {k} sets {extra}")
            entries.append((int(k), {"content": tok["content"],
                                     "normalized": tok.get("normalized", True),
                                     **{f: tok.get(f, False) for f in (
                                         "lstrip", "rstrip", "single_word", "special")}}))
    else:
        smap = _read_json(os.path.join(path, "special_tokens_map.json"), {})
        for key, value in smap.items():
            if key == "additional_special_tokens":
                have = list(config.get(key) or [])
                config[key] = have + [t for t in value if t not in have]
            else:
                config[key] = value
        special = set()
        for key in _SPECIAL_KEYS:
            value = config.get(key)
            for t in (value or ()) if key == "additional_special_tokens" else (value,):
                if _token_text(t) is not None:
                    special.add(_token_text(t))
        for text, k in (_read_json(os.path.join(path, "added_tokens.json"), {}) or {}).items():
            entries.append((int(k), {"content": text, "normalized": text not in special,
                                     "lstrip": False, "rstrip": False, "single_word": False,
                                     "special": text in special}))
    # PreTrainedTokenizerFast.__init__: the added tokens in id order, then
    # the named special tokens not yet among them
    order = [fields for _, fields in sorted(entries, key=lambda e: e[0])]
    named = []
    for key in _SPECIAL_KEYS:
        value = config[key] if key in config else _QWEN2_SPECIAL.get(key)
        for t in (value or ()) if key == "additional_special_tokens" else (value,):
            text = _token_text(t)
            if text is not None and text not in named:
                named.append(text)
    have = {f["content"] for f in order}
    order += [{"content": t, "normalized": False, "lstrip": False, "rstrip": False,
               "single_word": False, "special": True} for t in named if t not in have]
    # tokenizers' AddedVocabulary.add_tokens: the id a token already has,
    # else the next past both the vocabulary and the added ids
    ids: Dict[str, int] = {}
    added = []
    for fields in order:
        text = fields["content"]
        if not text:
            continue
        if text in ids or text in vocab:
            tid = ids.get(text, vocab.get(text))
        else:
            top = max(ids.values(), default=None)
            tid = len(vocab) if top is None or top < len(vocab) else top + 1
        ids[text] = tid
        added = [a for a in added if a["content"] != text] + [{"id": tid, **fields}]
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False,
                  "use_regex": False}
    return {
        "added_tokens": added, "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_PATTERN}, "behavior": "Isolated",
             "invert": False}, byte_level]},
        "post_processor": byte_level, "decoder": byte_level,
        "model": {"type": "BPE", "vocab": vocab, "merges": merges},
    }


def _check_pre_tokenizer(pt) -> None:
    if not pt or pt.get("type") != "Sequence" or len(pt.get("pretokenizers") or ()) != 2:
        _refuse(f"pre_tokenizer {pt and pt.get('type')!r} (Qwen2's is a Sequence of Split "
                f"and ByteLevel)")
    split, byte_level = pt["pretokenizers"]
    if split.get("type") != "Split":
        _refuse(f"pre_tokenizer {split.get('type')!r} where Qwen2 has Split")
    if split.get("pattern") != {"Regex": QWEN2_PATTERN}:
        _refuse(f"Split pattern {split.get('pattern')!r} (not Qwen2's)")
    if split.get("behavior") != "Isolated" or split.get("invert"):
        _refuse(f"Split behavior {split.get('behavior')!r} invert {split.get('invert')!r}")
    if byte_level.get("type") != "ByteLevel":
        _refuse(f"pre_tokenizer {byte_level.get('type')!r} where Qwen2 has ByteLevel")
    for flag in ("add_prefix_space", "use_regex"):
        if byte_level.get(flag):
            _refuse(f"ByteLevel {flag}: true")


def _check_model(m) -> None:
    if not m or m.get("type") != "BPE":
        _refuse(f"model {m and m.get('type')!r} (Qwen2's is BPE)")
    if m.get("byte_fallback"):
        _refuse("BPE byte_fallback: true")
    if m.get("dropout") is not None:
        _refuse(f"BPE dropout {m['dropout']!r}")
    for key in ("continuing_subword_prefix", "end_of_word_suffix"):
        if m.get(key):
            _refuse(f"BPE {key} {m[key]!r}")


class Tokenizer:
    """A Qwen2 byte-level BPE tokenizer (see the module docstring)."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        model = spec.get("model")
        _check_model(model)
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                _refuse(f"{key} is set")
        norm = spec.get("normalizer")
        if not norm or norm.get("type") != "NFC":
            _refuse(f"normalizer {norm and norm.get('type')!r} (Qwen2's is NFC)")
        _check_pre_tokenizer(spec.get("pre_tokenizer"))
        for key in ("post_processor", "decoder"):
            part = spec.get(key)
            if part is not None and part.get("type") != "ByteLevel":
                _refuse(f"{key} {part.get('type')!r} (Qwen2's is ByteLevel)")
        self.vocab: Dict[str, int] = dict(model["vocab"])
        missing = [b for b, ch in BYTE_CHARS.items() if ch not in self.vocab]
        if missing:
            _refuse(f"the vocabulary lacks byte-level characters for bytes {missing[:8]}")
        self.ignore_merges = bool(model.get("ignore_merges", False))
        self.ranks: Dict[Tuple[str, str], int] = {}
        for rank, merge in enumerate(model.get("merges") or ()):
            a, b = merge.split(" ", 1) if isinstance(merge, str) else merge
            if a not in self.vocab or b not in self.vocab or a + b not in self.vocab:
                _refuse(f"merge {merge!r} names a token outside the vocabulary")
            self.ranks[(a, b)] = rank
        self.added: Dict[str, int] = {}
        self.added_by_id: Dict[int, dict] = {}
        # the added tokens matched in the raw text, and those (normalized)
        # matched in its NFC form: {pattern: id} each
        self._raw: Dict[str, int] = {}
        self._normed: Dict[str, int] = {}
        for tok in spec.get("added_tokens") or ():
            for flag in ("lstrip", "rstrip", "single_word"):
                if tok.get(flag):
                    _refuse(f"added token {tok['content']!r} has {flag}: true")
            have = self.vocab.get(tok["content"])
            if have is not None and have != tok["id"]:
                _refuse(f"added token {tok['content']!r} is id {tok['id']} but the "
                        f"vocabulary's {have}")
            self.added[tok["content"]] = tok["id"]
            self.added_by_id[tok["id"]] = tok
            if tok.get("normalized"):
                self._normed[unicodedata.normalize("NFC", tok["content"])] = tok["id"]
            else:
                self._raw[tok["content"]] = tok["id"]
        if config is not None:
            self._check_config(config)
        self._raw_first = _first_chars(self._raw)
        self._normed_first = _first_chars(self._normed)
        self._cache: Dict[str, Tuple[int, ...]] = {}

    def _check_config(self, config: dict) -> None:
        if config.get("split_special_tokens"):
            raise ValueError("unsupported tokenizer_config.json: split_special_tokens: true")
        decoder = config.get("added_tokens_decoder")
        if decoder is None:
            return
        ids = {int(k) for k in decoder}
        if ids != set(self.added_by_id):
            raise ValueError(
                f"tokenizer_config.json's added_tokens_decoder has ids "
                f"{sorted(ids ^ set(self.added_by_id))[:8]} that tokenizer.json's "
                f"added_tokens does not share")
        for k, entry in decoder.items():
            tok = self.added_by_id[int(k)]
            for key, val in entry.items():
                if key != "__type" and tok.get(key, False) != val:
                    raise ValueError(
                        f"tokenizer_config.json disagrees with tokenizer.json on added "
                        f"token {k}: {key} {val!r} there, {tok.get(key)!r} here")

    @classmethod
    def from_file(cls, path: str, config_path: Optional[str] = None) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        config = None
        if config_path and os.path.exists(config_path):
            with open(config_path, encoding="utf-8") as f:
                config = json.load(f)
        return cls(spec, config)

    @classmethod
    def from_dir(cls, path: str) -> "Tokenizer":
        """``tokenizer.json`` in ``path``, held against the
        ``tokenizer_config.json`` beside it where there is one; else
        :func:`from_slow_files` where ``path`` holds ``vocab.json`` and
        ``merges.txt``."""
        kind = files_in(path)
        if kind == "slow":
            return cls(from_slow_files(path))
        if kind is None:
            raise FileNotFoundError(f"{path} holds neither tokenizer.json nor vocab.json "
                                    f"+ merges.txt")
        return cls.from_file(os.path.join(path, "tokenizer.json"),
                             os.path.join(path, "tokenizer_config.json"))

    def __len__(self) -> int:
        return max(max(self.vocab.values()), max(self.added_by_id, default=-1)) + 1

    def _split_added(self, text: str) -> List[Tuple[str, Optional[int]]]:
        """(piece, its id if it is an added token, else None) in order; the
        pieces between added tokens in NFC form."""
        out = []
        for piece, tid in _split(text, self._raw, self._raw_first):
            if tid is None:
                out.extend(_split(unicodedata.normalize("NFC", piece), self._normed,
                                  self._normed_first))
            else:
                out.append((piece, tid))
        return out

    def _bpe(self, word: str) -> Tuple[int, ...]:
        """The ids of one pre-token (in byte-level characters): the adjacent
        pair of the lowest merge rank merged first, the leftmost of equals."""
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        if self.ignore_merges and word in self.vocab:
            ids = (self.vocab[word],)
        else:
            syms: List[Optional[str]] = list(word)
            n = len(syms)
            nxt = list(range(1, n + 1))
            prv = list(range(-1, n - 1))
            ranks = self.ranks
            heap = []
            for i in range(n - 1):
                r = ranks.get((syms[i], syms[i + 1]))
                if r is not None:
                    heap.append((r, i))
            heapq.heapify(heap)
            while heap:
                r, i = heapq.heappop(heap)
                j = nxt[i]
                if syms[i] is None or j >= n or ranks.get((syms[i], syms[j])) != r:
                    continue  # a pair that a merge since has changed
                syms[i] += syms[j]
                syms[j] = None
                nxt[i] = nxt[j]
                if nxt[i] < n:
                    prv[nxt[i]] = i
                    r2 = ranks.get((syms[i], syms[nxt[i]]))
                    if r2 is not None:
                        heapq.heappush(heap, (r2, i))
                if prv[i] >= 0:
                    r2 = ranks.get((syms[prv[i]], syms[i]))
                    if r2 is not None:
                        heapq.heappush(heap, (r2, prv[i]))
            ids = tuple(self.vocab[s] for s in syms if s is not None)
        if len(self._cache) >= _CACHE_ENTRIES:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        """The ids of ``text``. A Qwen2 post-processor adds no token, so
        ``add_special_tokens`` changes nothing (it keeps the HF signature)."""
        ids: List[int] = []
        for piece, tid in self._split_added(text):
            if tid is not None:
                ids.append(tid)
                continue
            for word in pre_tokenize(piece):
                ids.extend(self._bpe("".join(BYTE_CHARS[b] for b in word.encode("utf-8"))))
        return ids
