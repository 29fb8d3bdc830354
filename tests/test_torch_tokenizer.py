"""The port's Qwen2 BPE tokenizer (``models/tokenizer.py``) against the JAX
package's ``load_hf_tokenizer`` (``transformers``' ``Qwen2TokenizerFast``).

The fixture is a byte-level BPE trained here with ``tokenizers``' BpeTrainer on
a fixed multi-script corpus under Qwen2's normalizer and pre-tokenizer, written
in Qwen2.5-VL's layout by ``chip_smoke.write_qwen2_tokenizer``: 151 643 base
ids (the learned merges, then unreachable entries) and the 22 added tokens
contiguous at 151 643-151 664, in both merge formats. ``AutoTokenizer``
renumbers added tokens given with gaps or past a short vocabulary, so the
layout must be the real one for the two sides to be comparable.
"""

import dataclasses
import json
import os
import shutil
import unicodedata

import jax
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
import test_torch_models as tm
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl as vl
from qwen_image_edit_streamdiffusion_tpu_torch.models import tokenizer as tk
from qwen_image_edit_streamdiffusion_tpu_torch.models.convert import from_jax

CORPUS = chip_smoke.TOKENIZER_CORPUS + (
    " The quick brown fox jumps over the lazy dog's back; THE DOG'LL WAKE. "
    "Les élèves n'ont pas vu l'arc-en-ciel. Zwölf Boxkämpfer jagen Viktor. "
    "東京タワーの夜景を描いてください。夜空に星を加えて。 2025年10月18日\n"
    "    def f(x):\n        return x * 2  # code\r\n")
FORMATS = ("strings", "pairs")
ALPHABET = ("aAbBzZ sStTrReEvVmMlLdD\u017f'\"\t\n\r\x0b\x0c\x1c\x1f\xa0\u3000\u2003"
            ".,;!?-()1234567890\u0661\u0662\uff14\uff15\u00bd\u216b\u00e9e\u0301\u0308"
            "\u4e2d\u6587\u3042\u30a2\ud55c\uae00\u0418\u0438\u03a9\U0001f3a8\u2728"
            "\U0001f44d\U0001f3fd\u200d")
PIECES = ("'s", "'S", "'re", "'RE", "'ll", "'Ll", "'ve", "'m", "'d", "'t", "'x",
          "\r\n", "\n\n", "   ", "\t\t", " \n ", "!!!\n", "...\r\n", "é", "Å",
          "<|im_start|>", "<|im_end|>", "<|image_pad|>", "<tool_call>", "</tool_call>",
          "<|endoftext|>", "<|fim_prefix|>", "<|im_end", "Picture 1: ", "make it")


def _trained_merges():
    from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(tk.QWEN2_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=256 + 600, show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator([CORPUS] * 4, trainer)
    merges = json.loads(tok.to_str())["model"]["merges"]
    return [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in merges]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"strings" | "pairs" | "learned": directory}: the trained merges in
    both formats, and the chip script's own learned file."""
    merges = _trained_merges()
    assert len(merges) > 300
    root = tmp_path_factory.mktemp("tok")
    out = {}
    for fmt in FORMATS:
        out[fmt] = str(root / fmt)
        chip_smoke.write_qwen2_tokenizer(out[fmt], merges, pair_merges=fmt == "pairs")
    out["learned"] = str(root / "learned")
    chip_smoke.write_qwen2_tokenizer(out["learned"])
    return out


@pytest.fixture(scope="module")
def pairs(dirs):
    """{name: (port tokenizer, JAX package's tokenizer)}."""
    return {name: (vl.load_hf_tokenizer(d), jvl.load_hf_tokenizer(d)) for name, d in dirs.items()}


def test_layout_is_qwen2_vl(dirs, pairs):
    with open(os.path.join(dirs["strings"], "tokenizer.json")) as f:
        assert isinstance(json.load(f)["model"]["merges"][0], str)
    with open(os.path.join(dirs["pairs"], "tokenizer.json")) as f:
        assert isinstance(json.load(f)["model"]["merges"][0], list)
    for port, hf in pairs.values():
        assert len(port) == len(hf) == 151665
        for text, want in vl._SPECIAL_IDS.items():
            assert port.added[text] == want == hf.convert_tokens_to_ids(text)
        assert port.added["<|endoftext|>"] == 151643 and port.added["<|file_sep|>"] == 151664


@pytest.mark.parametrize("fmt", FORMATS)
def test_chat_template_ids_match_jax(pairs, fmt):
    port, hf = pairs[fmt]
    for prompt, n_images in (("Transform into oil painting style", 1),
                             ("Replace the sky with stars; don't touch the cat's fur!", 2),
                             ("把天空换成星空，保留人物。\n  Keep   the\tlayout. 🎨", 3)):
        merged = [6 + i for i in range(n_images)]
        got = vl.build_chat_ids(port, prompt, merged)
        want = jvl.build_chat_ids(hf, prompt, merged)
        assert got == want
        assert got[0] != vl.build_chat_ids(vl.SimpleTokenizer(152064), prompt, merged)[0]
    # the upstream template's fixed drop index is the prefix's length
    assert len(vl._tokenize(port, vl.TEMPLATE_PREFIX)) == len(hf.encode(
        jvl.TEMPLATE_PREFIX, add_special_tokens=False))


TEXT = st.lists(st.one_of(st.sampled_from(PIECES), st.text(ALPHABET, max_size=8),
                          st.text(st.characters(exclude_categories=("Cs", "Cn")), max_size=4)),
                max_size=12).map("".join)


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_matches_jax_on_generated_text(pairs, fmt):
    port, hf = pairs[fmt]

    @settings(max_examples=250, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(TEXT)
    def check(text):
        assert port.encode(text, add_special_tokens=False) == hf.encode(
            text, add_special_tokens=False), repr(text)

    check()


def test_learned_file_of_the_chip_script_matches_jax(pairs):
    port, hf = pairs["learned"]
    # the ids chip_smoke.py holds the card host's tokenizer to
    assert tuple(hf.encode(chip_smoke.PROMPT, add_special_tokens=False)) == \
        chip_smoke.TOKENIZER_PROMPT_IDS
    for text in (chip_smoke.PROMPT, chip_smoke.TOKENIZER_CORPUS, CORPUS, vl.TEMPLATE_PREFIX,
                 chip_smoke.LONG_NEG, "it'S ALRIGHT 'ſx\r\n\r\n  end  ", " " * 300 + "x"):
        assert port.encode(text) == hf.encode(text, add_special_tokens=False), repr(text)


def _kind_hf(pt, c: str) -> str:
    """The class the ``tokenizers`` regex engine gives ``c``, probed."""
    pieces = lambda s: [p for p, _ in pt.pre_tokenize_str(s)]  # noqa: E731
    if len(pieces("a" + c + "a")) == 1:
        return "L"
    if len(pieces(c + c)) == 2 and c != "'":
        return "N"
    return "o" if len(pieces("!" + c + "!")) == 1 else "s"


# Unicode's White_Space property (PropList.txt), the pattern's \s
WHITE_SPACE = {*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B), 0x2028,
               0x2029, 0x202F, 0x205F, 0x3000}


def _kind_unicode(c: str) -> str:
    """The class Python's Unicode tables give ``c`` under the pattern's
    definitions: ``\\p{L}``, ``\\p{N}``, ``\\s``, or another character."""
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else ("s" if ord(c) in WHITE_SPACE else "o")


# the code point in and beside a letter run, twice beside itself (a digit
# splits, punctuation joins, whitespace runs), after a contraction's
# apostrophe, before a line break and at the end
CONTEXT = "a{c}{c} x'{c}x!{c}\n{c}"


def test_pre_tokenizer_over_every_assigned_code_point(dirs):
    """Every code point Python's tables assign (category not Cn, no
    surrogates) in fixed contexts, against ``pre_tokenize_str``. A
    disagreement is allowed only where the two Unicode tables class the code
    point differently (Python's, against what ``tokenizers``' regex engine
    does with it); each such code point is named, and any other fails."""
    from tokenizers import Tokenizer

    pt = Tokenizer.from_file(os.path.join(dirs["strings"], "tokenizer.json")).pre_tokenizer
    cps = [c for c in range(0x110000) if not 0xD800 <= c < 0xE000
           and unicodedata.category(chr(c)) != "Cn"]
    byte_level = lambda s: "".join(tk.BYTE_CHARS[b] for b in s.encode())  # noqa: E731
    chunks = [CONTEXT.format(c=chr(c)) for c in cps]
    want = [p for p, _ in pt.pre_tokenize_str("".join(chunks))]
    differ = []
    if [byte_level(p) for p in tk.pre_tokenize("".join(chunks))] != want:
        for c, chunk in zip(cps, chunks):  # find them, chunk by chunk
            if [p for p, _ in pt.pre_tokenize_str(chunk)] != [
                    byte_level(p) for p in tk.pre_tokenize(chunk)]:
                differ.append(c)
    named = [(f"U+{c:04X} {unicodedata.name(chr(c), '?')}", _kind_unicode(chr(c)),
              _kind_hf(pt, chr(c))) for c in differ]
    wrong = [n for n in named if n[1] == n[2]]
    assert not wrong, f"split differently where the tables agree: {wrong[:20]}"
    if named:
        print("code points the two Unicode tables class differently:", named)


def test_vl_encoder_with_the_real_vocabulary_matches_jax(dirs, pairs):
    """A `tiny`-width encoder with vocab_size 152 064 (no id clamps), the
    port's tokenizer against the JAX encoder with the HF one, same weights."""
    cfg = dataclasses.replace(tm.VL32, vocab_size=152064)
    jparams = tm._numpy_tree(jvl._init_all, cfg)
    port, hf = pairs["strings"]
    img = tm._rng(12).integers(0, 256, (56, 84, 3)).astype(np.uint8)
    prompt = "Replace the sky with stars; don't change the cat's fur 🎨"
    jenc = jvl.QwenVLEncoder(cfg, params=jparams, tokenizer=hf, max_len=cfg.max_text_len)
    enc = vl.QwenVLEncoder(cfg, from_jax(jparams, cfg), device="cpu", tokenizer=port,
                           max_len=cfg.max_text_len)
    want = jenc.encode(prompt, [img])
    got = enc.encode(prompt, [img])
    np.testing.assert_array_equal(got.mask, np.asarray(want.mask))
    tm._close(got.embeds, want.embeds)
    ids = vl.build_chat_ids(port, prompt, [6])[0]
    assert max(ids) >= 151643 and max(i for i in ids if i < 151643) > 255
    jax.clear_caches()


def _edited(src: str, dst, spec_edit=None, config_edit=None) -> str:
    shutil.copytree(src, dst)
    for name, edit in (("tokenizer.json", spec_edit), ("tokenizer_config.json", config_edit)):
        if edit is None:
            continue
        path = os.path.join(dst, name)
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        edit(data)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f)
    return str(dst)


def _set(*path_value):
    *path, value = path_value

    def edit(d):
        for k in path[:-1]:
            d = d[k]
        d[path[-1]] = value
    return edit


@pytest.mark.parametrize("case,spec_edit,config_edit,match", [
    ("normalizer", _set("normalizer", {"type": "NFKC"}), None, "normalizer 'NFKC'"),
    ("byte_fallback", _set("model", "byte_fallback", True), None, "byte_fallback"),
    ("lstrip", _set("added_tokens", 1, "lstrip", True), None, "lstrip"),
    ("pattern", _set("pre_tokenizer", "pretokenizers", 0, "pattern", {"Regex": r"\s+"}), None,
     "Split pattern"),
    ("model", _set("model", "type", "WordPiece"), None, "model 'WordPiece'"),
    ("config", None, _set("added_tokens_decoder", "151644", "special", False),
     "disagrees with tokenizer.json on added token 151644"),
    ("config_ids", None, _set("added_tokens_decoder", "151700",
                              {"content": "<x>", "special": True}), "added_tokens_decoder"),
])
def test_refusals_name_what_they_refuse(dirs, tmp_path, case, spec_edit, config_edit, match):
    d = _edited(dirs["strings"], tmp_path / case, spec_edit, config_edit)
    with pytest.raises(ValueError, match=match):
        vl.load_hf_tokenizer(d)


def test_load_and_encode_time_at_full_size(dirs):
    """The full-size file loads once per tokenizer and caches its BPE words
    (CPU figures only bound the test; the card host's are chip_smoke's)."""
    import time

    t0 = time.perf_counter()
    tok = tk.Tokenizer.from_dir(dirs["learned"])
    load_s = time.perf_counter() - t0
    assert len(tok.ranks) > 150_000 and load_s < 20
    ids = tok.encode(chip_smoke.PROMPT)
    assert ids == tok.encode(chip_smoke.PROMPT) and len(tok._cache) >= len(ids) // 2


# -- the slow files: vocab.json + merges.txt ---------------------------------

SLOW = ("slow", "added_only")


@pytest.fixture(scope="module")
def slow_dirs(dirs, tmp_path_factory):
    """{"slow" | "added_only": directory}: the trained tokenizer saved by
    ``save_pretrained(legacy_format=True)`` with its tokenizer.json removed;
    ``added_only`` also without the config's ``added_tokens_decoder``, so
    the added tokens come from ``added_tokens.json`` alone."""
    from transformers import AutoTokenizer

    root = tmp_path_factory.mktemp("slow")
    out = {name: str(root / name) for name in SLOW}
    for d in out.values():
        AutoTokenizer.from_pretrained(dirs["strings"]).save_pretrained(d, legacy_format=True)
        if os.path.exists(os.path.join(d, "tokenizer.json")):
            os.remove(os.path.join(d, "tokenizer.json"))
    path = os.path.join(out["added_only"], "tokenizer_config.json")
    with open(path, encoding="utf-8") as f:
        config = json.load(f)
    del config["added_tokens_decoder"]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(config, f)
    return out


@pytest.fixture(scope="module")
def slow_pairs(slow_dirs):
    return {name: (vl.load_hf_tokenizer(d), jvl.load_hf_tokenizer(d))
            for name, d in slow_dirs.items()}


@pytest.mark.parametrize("name", SLOW)
def test_slow_files_layout(slow_dirs, slow_pairs, name):
    d = slow_dirs[name]
    assert tk.files_in(d) == "slow" and not os.path.exists(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "merges.txt"), encoding="utf-8") as f:
        assert f.readline().startswith("#version:")
    port, hf = slow_pairs[name]
    assert type(hf).__name__ == "Qwen2TokenizerFast"
    assert len(port) == len(hf) == 151665
    for text, want in vl._SPECIAL_IDS.items():
        assert port.added[text] == want == hf.convert_tokens_to_ids(text)
    # added_tokens.json alone: the tokens the config does not name special
    # are matched in the normalized text, as transformers marks them
    normed = {t["content"] for t in port.added_by_id.values() if t["normalized"]}
    assert normed == (set() if name == "slow" else {
        t for t, special in chip_smoke.QWEN2_VL_ADDED if not special})


@pytest.mark.parametrize("name", SLOW)
def test_slow_files_chat_template_ids_match_jax_and_tokenizer_json(pairs, slow_pairs, name):
    port, hf = slow_pairs[name]
    fast = pairs["strings"][0]
    for prompt, n_images in (("Transform into oil painting style", 1),
                             ("Replace the sky with stars; don't touch the cat's fur!", 2),
                             ("把天空换成星空，保留人物。\n  Keep   the\tlayout. 🎨", 3)):
        merged = [6 + i for i in range(n_images)]
        got = vl.build_chat_ids(port, prompt, merged)
        assert got == jvl.build_chat_ids(hf, prompt, merged)
        assert got == vl.build_chat_ids(fast, prompt, merged)


@pytest.mark.parametrize("name", SLOW)
def test_slow_files_encode_matches_jax_on_generated_text(pairs, slow_pairs, name):
    port, hf = slow_pairs[name]
    fast = pairs["strings"][0]

    @settings(max_examples=150, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(TEXT)
    def check(text):
        got = port.encode(text)
        assert got == hf.encode(text, add_special_tokens=False), repr(text)
        assert got == fast.encode(text), repr(text)

    check()


def _slow_edited(src: str, dst, name: str, edit) -> str:
    shutil.copytree(src, dst)
    path = os.path.join(dst, name)
    if name.endswith(".json"):
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        edit(data)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f)
    else:
        with open(path, "a", encoding="utf-8") as f:
            f.write(edit)
    return str(dst)


@pytest.mark.parametrize("case,name,edit,match", [
    ("merge_line", "merges.txt", "a b c\n", "line .* is not two tokens"),
    ("merge_oov", "merges.txt", "€ €\n", "outside the vocabulary"),
    ("class", "tokenizer_config.json", _set("tokenizer_class", "LlamaTokenizer"),
     "tokenizer_class 'LlamaTokenizer'"),
    ("prefix_space", "tokenizer_config.json", _set("add_prefix_space", True),
     "add_prefix_space"),
    ("unknown_key", "tokenizer_config.json", _set("do_lower_case", True), "do_lower_case"),
    ("lstrip", "tokenizer_config.json", _set("added_tokens_decoder", "151644", "lstrip", True),
     "lstrip"),
    ("vocab", "vocab.json", lambda d: d.update({"x": "y"}), "vocab.json"),
])
def test_slow_files_refusals_name_what_they_refuse(slow_dirs, tmp_path, case, name, edit, match):
    d = _slow_edited(slow_dirs["slow"], tmp_path / case, name, edit)
    with pytest.raises(ValueError, match=match):
        vl.load_hf_tokenizer(d)


def test_slow_files_renumber_as_tokenizers_does(slow_dirs, tmp_path):
    """Added ids given with a gap, and an eos that special_tokens_map.json
    names (over the config's) but no file lists, get the ids that
    ``tokenizers`` assigns as it adds them."""
    d = _slow_edited(slow_dirs["added_only"], tmp_path / "gap", "added_tokens.json",
                     lambda a: a.update({"<|file_sep|>": 151700}))
    with open(os.path.join(d, "special_tokens_map.json"), encoding="utf-8") as f:
        smap = json.load(f)
    smap["eos_token"] = "<|my_eos|>"
    with open(os.path.join(d, "special_tokens_map.json"), "w", encoding="utf-8") as f:
        json.dump(smap, f)
    port, hf = vl.load_hf_tokenizer(d), jvl.load_hf_tokenizer(d)
    assert port.added["<|file_sep|>"] == hf.convert_tokens_to_ids("<|file_sep|>") == 151664
    assert port.added["<|my_eos|>"] == hf.convert_tokens_to_ids("<|my_eos|>") == 151665
    text = "x<|my_eos|><|file_sep|><tool_call>y"
    assert port.encode(text) == hf.encode(text, add_special_tokens=False)
    assert len(port) == len(hf)


def test_a_directory_without_tokenizer_files_raises(tmp_path):
    assert tk.files_in(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="vocab.json"):
        tk.Tokenizer.from_dir(str(tmp_path))


def test_slow_files_normalized_added_tokens_match_after_nfc(slow_dirs, tmp_path):
    """An added token from ``added_tokens.json`` that the config does not
    name special is ``normalized``: it matches the NFC form of the text
    around the raw added tokens, as ``tokenizers`` matches it, so a
    decomposed token matches precomposed text and the other way round."""
    decomposed, precomposed = "Cafe\u0301", "Caf\u00e9"
    d = _slow_edited(slow_dirs["added_only"], tmp_path / "nfc", "added_tokens.json",
                     lambda a: a.update({decomposed: 151665, "A\u030angstr": 151666}))
    port, hf = vl.load_hf_tokenizer(d), jvl.load_hf_tokenizer(d)
    for text in (precomposed + " cr\u00e8me", decomposed + " cre\u0300me",
                 "\u00c5ngstrom<|im_start|>" + decomposed, "A\u030angstr\u00f6m",
                 "x<tool_call>" + precomposed + "<|im_end|>"):
        assert port.encode(text) == hf.encode(text, add_special_tokens=False), repr(text)
    assert port.encode(precomposed) == port.encode(decomposed) == [151665]
