"""The port's HF Llama import and export against the JAX package's, and
against a live HF model, on the CPU (tests/test_hf_import.py).

- ``llama_params_from_hf`` gives the reference's flax tree exactly, leaf by
  leaf (tied and untied, GQA and MHA, rope scaling), for the reference's tiny
  random ``LlamaConfig`` of ``examples/finetune_hf.py`` (seeded), and a
  bfloat16 ``dtype`` rounds as torch does;
- the imported port ``DecoderLM`` gives HF's logits and the reference
  model's within tests/test_hf_import.py's tolerances (2e-4; 3e-4 with
  linear or llama3 rope scaling), Mistral's sliding window included;
- the export round trip through a loaded ``DecoderLM`` (``load_flax_params``
  -> ``to_flax_params`` -> ``hf_state_dict_from_params``) is exact and equal
  to the reference's export, and loads strictly into a fresh HF model;
- unsupported scaling, a scaling dict with no type, a missing and an
  unconverted weight raise the reference's errors;
- ``examples.finetune_hf.main`` finetunes, samples and exports on the CPU,
  with and without ``--lora 4``; ``examples.generate_text --hf DIR`` decodes a
  saved checkpoint, greedy row 0 equal to HF's own ``generate``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from dmlcloud_tpu.models import hf as jhf
from dmlcloud_tpu.models import transformer as jtr
from dmlcloud_tpu_torch.models import hf
from dmlcloud_tpu_torch.models.transformer import DecoderLM, load_flax_params, to_flax_params

torch.set_num_threads(2)

LLAMA3 = {"rope_type": "llama3", "factor": 4.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
          "original_max_position_embeddings": 32}


def _tiny_hf(tie=False, kv_heads=2, rope_scaling=None, seed=0):
    """The reference finetune's tiny random Llama (examples/finetune_hf.py:34-52)."""
    cfg = transformers.LlamaConfig(
        vocab_size=257, hidden_size=64, intermediate_size=160, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=256, tie_word_embeddings=tie,
        rope_scaling=dict(rope_scaling) if rope_scaling else None, attn_implementation="eager",
    )
    torch.manual_seed(seed)
    return cfg, transformers.LlamaForCausalLM(cfg).eval()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def _assert_same_tree(got, want):
    got, want = _leaves(got), _leaves(want)
    assert list(got) == list(want)
    for path in want:
        assert got[path].dtype == want[path].dtype and got[path].shape == want[path].shape, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)


def _port_model(hf_cfg, hf_model, **overrides):
    cfg = hf.transformer_config_from_hf(hf_cfg, dtype=torch.float32, **overrides)
    return load_flax_params(DecoderLM(cfg, device="cpu"), hf.llama_params_from_hf(hf_model.state_dict(), cfg)), cfg


CASES = {
    "untied_gqa": dict(), "untied_mha": dict(kv_heads=4), "tied": dict(tie=True),
    "linear": dict(rope_scaling={"rope_type": "linear", "factor": 2.0}), "llama3": dict(rope_scaling=LLAMA3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_params_and_logits_match_the_reference_and_hf(case):
    hf_cfg, hf_model = _tiny_hf(**CASES[case])
    jcfg = jhf.transformer_config_from_hf(hf_cfg, dtype=jnp.float32)
    jparams = jhf.llama_params_from_hf(hf_model.state_dict(), jcfg)
    model, cfg = _port_model(hf_cfg, hf_model)
    assert cfg.rope_scaling == jcfg.rope_scaling and cfg.tie_embeddings == jcfg.tie_embeddings
    _assert_same_tree(hf.llama_params_from_hf(hf_model.state_dict(), cfg),
                      jax.tree_util.tree_map(np.asarray, jparams))

    tokens = np.random.RandomState(8).randint(0, 257, size=(2, 40))  # long enough to scale
    with torch.no_grad():
        want = hf_model(torch.from_numpy(tokens)).logits.numpy()
        got = model(torch.from_numpy(tokens)).numpy()
    ref = np.asarray(jtr.DecoderLM(jcfg).apply({"params": jparams}, jnp.asarray(tokens)))
    tol = 3e-4 if cfg.rope_scaling else 2e-4
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


def test_mistral_window_and_decoupled_head_dim_match_hf():
    for kw, seed in ((dict(hidden_size=32, sliding_window=6), 2),
                     (dict(hidden_size=40, head_dim=16, sliding_window=None), 3)):
        hf_cfg = transformers.MistralConfig(vocab_size=61, intermediate_size=64, num_hidden_layers=2,
                                            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                                            attn_implementation="eager", **kw)
        torch.manual_seed(seed)
        hf_model = transformers.MistralForCausalLM(hf_cfg).eval()
        model, cfg = _port_model(hf_cfg, hf_model)
        assert cfg.sliding_window == kw.get("sliding_window") and cfg.head_dim == kw.get("head_dim", 8)
        tokens = np.random.RandomState(seed).randint(0, 61, size=(2, 13))
        with torch.no_grad():
            np.testing.assert_allclose(model(torch.from_numpy(tokens)).numpy(),
                                       hf_model(torch.from_numpy(tokens)).logits.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("case", ["untied_gqa", "tied", "linear", "llama3"])
def test_export_round_trip_is_exact(case):
    hf_cfg, hf_model = _tiny_hf(**CASES[case])
    sd = {k: v.numpy() for k, v in hf_model.state_dict().items() if "rotary_emb" not in k}
    model, cfg = _port_model(hf_cfg, hf_model)
    back = hf.hf_state_dict_from_params(to_flax_params(model), cfg)
    assert sorted(back) == sorted(sd)
    for key in sd:
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], sd[key], err_msg=key)
    # the reference exports the same dict from its own import
    jcfg = jhf.transformer_config_from_hf(hf_cfg, dtype=jnp.float32)
    jback = jhf.hf_state_dict_from_params(jhf.llama_params_from_hf(hf_model.state_dict(), jcfg), jcfg)
    assert sorted(jback) == sorted(back) and all(np.array_equal(jback[k], back[k]) for k in back)
    fresh = transformers.LlamaForCausalLM(hf_cfg).eval()
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()})  # strict
    tokens = np.random.RandomState(4).randint(0, 257, size=(1, 10))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(torch.from_numpy(tokens)).logits.numpy(),
                                      hf_model(torch.from_numpy(tokens)).logits.numpy())


def test_bfloat16_dtype_rounds_as_torch_does():
    hf_cfg, hf_model = _tiny_hf()
    cfg = hf.transformer_config_from_hf(hf_cfg)
    full = _leaves(hf.llama_params_from_hf(hf_model.state_dict(), cfg))
    for dtype in (torch.bfloat16, np.float16):
        got = _leaves(hf.llama_params_from_hf(hf_model.state_dict(), cfg, dtype))
        for path, leaf in full.items():
            if dtype is torch.bfloat16:
                want = torch.from_numpy(np.ascontiguousarray(leaf)).to(torch.bfloat16).float().numpy()
            else:
                want = leaf.astype(np.float16)
            assert got[path].dtype == want.dtype
            np.testing.assert_array_equal(got[path], want, err_msg=path)


def _errors(fn):
    try:
        fn()
    except (KeyError, ValueError) as exc:
        return type(exc), str(exc)
    return None


def test_errors_are_the_references():
    hf_cfg, hf_model = _tiny_hf()
    fake = types.SimpleNamespace(vocab_size=61, num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
                                 hidden_size=32, intermediate_size=64, max_position_embeddings=64, rope_theta=1e4,
                                 tie_word_embeddings=False, sliding_window=None, head_dim=8,
                                 rope_scaling={"rope_type": "yarn", "factor": 2.0})
    missing = dict(hf_model.state_dict())
    missing.pop("model.layers.0.self_attn.q_proj.weight")
    extra = dict(hf_model.state_dict(), **{"model.layers.0.unexpected.weight": torch.zeros(2)})
    cfg, jcfg = hf.transformer_config_from_hf(hf_cfg), jhf.transformer_config_from_hf(hf_cfg)
    calls = [
        (lambda m: lambda: m.transformer_config_from_hf(fake), "yarn"),
        (lambda m: lambda: m._rope_scaling_from_hf({"factor": 8.0}), "rope_type"),
        (lambda m: lambda: m.llama_params_from_hf(missing, cfg if m is hf else jcfg), "q_proj"),
        (lambda m: lambda: m.llama_params_from_hf(extra, cfg if m is hf else jcfg), "unconverted"),
    ]
    for call, match in calls:
        got, want = _errors(call(hf)), _errors(call(jhf))
        assert got is not None and got == want and match in got[1]
    assert hf._rope_scaling_from_hf(None) is None and hf._rope_scaling_from_hf({"rope_type": "default"}) is None


FINETUNE_ARGV = ["--device", "cpu", "--epochs", "1", "--n-docs", "48", "--seq-len", "64", "--batch-size", "4",
                 "--sample", "6"]


@pytest.mark.parametrize("extra", [[], ["--lora", "4"], ["--mesh", "fsdp=1"]], ids=["full", "lora4", "mesh_fsdp1"])
def test_finetune_hf_example_runs_on_the_cpu(extra, tmp_path, capsys):
    from dmlcloud_tpu_torch.examples import finetune_hf
    from dmlcloud_tpu_torch.parallel import runtime

    export = tmp_path / "ft.npz"
    try:
        stage = finetune_hf.main([*FINETUNE_ARGV, "--export", str(export), *extra])
    finally:
        runtime.deinitialize()
    losses = [float(x) for x in stage.train_losses]
    assert len(losses) >= 3 and all(np.isfinite(losses))
    assert tuple(stage.sample_output.shape) == (2, 6)
    printed = capsys.readouterr().out
    assert "prompt [" in printed and "exported HF state dict (21 tensors)" in printed
    hf_cfg, hf_model = _tiny_hf()
    sd = dict(np.load(export))
    fresh = transformers.LlamaForCausalLM(hf_cfg).eval()
    fresh.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})  # strict
    start = hf_model.state_dict()
    moved = [k for k in sd if not np.array_equal(sd[k], start[k].numpy())]
    if "--lora" in extra:  # only the adapted kernels move; norms and the embedding stay the base's
        assert stage.lora is not None and moved and not any("norm" in k or "embed" in k for k in moved)
    else:
        assert "model.embed_tokens.weight" in moved and "model.norm.weight" in moved
    if "--mesh" in extra:  # FSDP2 over one process: the losses of the plain run (PERF.md section 2: 1e-5)
        assert stage.pipeline.models["lm"].plan.fsdp
        plain = [float(x) for x in finetune_hf.main(FINETUNE_ARGV).train_losses]
        runtime.deinitialize()
        np.testing.assert_allclose(losses, plain, rtol=1e-5)


def test_generate_text_decodes_a_saved_hf_checkpoint(tmp_path, capsys):
    from dmlcloud_tpu_torch.examples import generate_text

    hf_cfg, hf_model = _tiny_hf()
    hf_model.save_pretrained(tmp_path)
    tokens = generate_text.main(["--device", "cpu", "--hf", str(tmp_path), "--max-new", "6"])
    assert tuple(tokens.shape) == (2, 6) and "row 0 (greedy)" in capsys.readouterr().out
    prompt = np.random.RandomState(0).randint(0, 257, (2, 12))
    with torch.no_grad():
        want = hf_model.generate(torch.from_numpy(prompt[:1]), max_new_tokens=6, do_sample=False, pad_token_id=0,
                                 eos_token_id=None).numpy()[:, 12:]
    np.testing.assert_array_equal(tokens[:1].numpy(), want)
