"""The port's CLIP text and vision transformers (gaussianip_tpu_torch/
diffusion/clip.py) and BPE tokenizer (guidance/tokenizer.py) against the
JAX package's loaders (gaussianip_tpu/system/pipeline.py:
load_text_encoder and load_image_encoder, transformers' Flax classes with
from_pt) and transformers' own models, on tiny checkpoints written by
transformers' save_pretrained, in the pattern of
tests/test_text_encoder_parity.py.

Tolerances (max |diff| of float32 hidden states): 5e-5 against the Flax
path, 1e-5 against the torch transformers model. Token ids exact against
transformers' CLIPTokenizer without ftfy (this environment has none), on
a handmade vocabulary of every byte symbol plus some merges.
"""

import json

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)
FLAX_TOL = 5e-5
TORCH_TOL = 1e-5
PROMPTS = ["a person", "Audrey Hepburn wearing a tailored blazer, a shirt "
           "underneath, straight-cut trousers, and low-heeled shoes.", ""]


def _handmade_tokenizer(d, pad_token=None):
    """A CLIP tokenizer directory: every byte symbol (alone and
    word-final), a few merges, BOS / EOS; saved by transformers."""
    from transformers import CLIPTokenizer

    from gaussianip_tpu_torch.guidance.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>"
                                                   for s in symbols])}
    merges = ["a u", "au d", "r e", "e y</w>", "h e", "he p", "t h",
              "th e</w>", "i n", "in g</w>", "e r", "s h", "o e", "s</w>",
              "' s</w>", "p er", "per so", "perso n</w>"]
    for m in merges:
        vocab[m.replace(" ", "")] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    d.mkdir(parents=True, exist_ok=True)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges)
                                  + "\n")
    kw = {} if pad_token is None else {"pad_token": pad_token}
    tok = CLIPTokenizer(str(d / "vocab.json"), str(d / "merges.txt"), **kw)
    tok.save_pretrained(str(d))
    return tok, len(vocab)


@pytest.fixture(scope="module")
def text_checkpoint(tmp_path_factory):
    from transformers import CLIPTextConfig, CLIPTextModel

    root = tmp_path_factory.mktemp("sd")
    tok, n_vocab = _handmade_tokenizer(root / "tokenizer")
    cfg = CLIPTextConfig(vocab_size=n_vocab, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=77)
    torch.manual_seed(0)
    pt = CLIPTextModel(cfg).eval()
    pt.save_pretrained(str(root / "text_encoder"))
    return str(root), tok, pt


def test_text_encoder_matches_jax_and_transformers(text_checkpoint):
    from gaussianip_tpu.system.pipeline import load_text_encoder as jload
    from gaussianip_tpu_torch.system.pipeline import load_text_encoder

    root, tok, pt = text_checkpoint
    got = load_text_encoder(root, "cpu")(PROMPTS)
    ref = jload(root)(PROMPTS)
    ids = tok(PROMPTS, padding="max_length", max_length=77, truncation=True,
              return_tensors="pt").input_ids
    with torch.no_grad():
        ref_pt = pt(ids).last_hidden_state.numpy()
    assert got.shape == ref.shape == (3, 77, 32)
    assert np.abs(got - ref).max() < FLAX_TOL
    assert np.abs(got - ref_pt).max() < TORCH_TOL


@pytest.mark.parametrize("safe", [True, False],
                         ids=["model.safetensors", "pytorch_model.bin"])
def test_image_encoder_penultimate_matches_jax(tmp_path, safe):
    """A full CLIPModel checkpoint (text and vision towers, projections):
    the port reads its vision_config and vision_model.* weights, and
    returns hidden_states[-2]."""
    from transformers import CLIPConfig, CLIPModel

    from gaussianip_tpu.system.pipeline import load_image_encoder as jload
    from gaussianip_tpu_torch.system.pipeline import load_image_encoder

    torch.manual_seed(1)
    full = CLIPModel(CLIPConfig(
        text_config=dict(vocab_size=99, hidden_size=16, intermediate_size=32,
                         num_hidden_layers=1, num_attention_heads=2),
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=3, num_attention_heads=2,
                           image_size=224, patch_size=14, hidden_act="gelu"),
        projection_dim=8)).eval()
    full.save_pretrained(str(tmp_path), safe_serialization=safe)

    rng = np.random.default_rng(2)
    images = rng.uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    got = load_image_encoder(str(tmp_path), "cpu")(images).numpy()
    ref = jload(str(tmp_path))(images)
    assert got.shape == ref.shape == (2, 257, 32)
    assert np.abs(got - ref).max() < FLAX_TOL


TOKENIZER_CASES = {
    "ascii": "Audrey Hepburn wearing a tailored blazer, a shirt "
             "underneath, straight-cut trousers, and low-heeled shoes.",
    "empty": "",
    "punctuation": "hello!!! ??? ... --- (paren) [br] {c} @#$%^&*_+=~`|\\/<>",
    "contractions": "it's they're we've I'm you'll he'd IT'S",
    "digits": "123 4567 room 42b 3.14",
    "capitals": "FULL BODY PHOTO, Left Front View",
    "accents": "Café naïve résumé Ångström combining é",
    "cjk": "日本語のテキスト 中文 한국어",
    "number_forms": "x² ½ Ⅻ ① ٣ ⅷ",
    "whitespace": "tab\there\nnew  line\xa0nbsp ls zero​width",
    "emoji": "emoji 😀 👍🏽",
    "special_tokens": "<|startoftext|>x<|endoftext|> y",
    "long": " ".join(["wearing a shirt"] * 40),
}


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    from gaussianip_tpu_torch.guidance.tokenizer import CLIPTokenizer

    d = tmp_path_factory.mktemp("tok")
    hf, _ = _handmade_tokenizer(d)
    return hf, CLIPTokenizer.from_pretrained(str(d))


@pytest.mark.parametrize("case", sorted(TOKENIZER_CASES))
def test_tokenizer_ids_exact(tokenizers, case):
    hf, port = tokenizers
    assert getattr(hf, "fix_text", None) is None  # the path without ftfy
    text = TOKENIZER_CASES[case]
    ref = hf([text], padding="max_length", max_length=77, truncation=True,
             return_tensors="np").input_ids
    got = port([text])
    assert got.dtype == np.int64 and got.shape == (1, 77)
    assert np.array_equal(got, ref), (text, got, ref)


def test_tokenizer_reads_special_tokens(tmp_path):
    """A pad token other than EOS (as some checkpoints set) comes from the
    saved special_tokens_map.json / tokenizer_config.json."""
    from transformers import CLIPTokenizer as HF

    from gaussianip_tpu_torch.guidance.tokenizer import CLIPTokenizer

    _handmade_tokenizer(tmp_path, pad_token="!")
    hf = HF.from_pretrained(str(tmp_path))
    port = CLIPTokenizer.from_pretrained(str(tmp_path))
    ref = hf(PROMPTS, padding="max_length", max_length=77, truncation=True,
             return_tensors="np").input_ids
    assert port.pad == "!"
    assert np.array_equal(port(PROMPTS), ref)
