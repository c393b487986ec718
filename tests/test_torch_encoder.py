"""The port's encoder families (the encoder core, BERT, ViT, CLIP) against the
JAX package, on the CPU.

Weights cross the bridges (``models.encoder.load_flax_params``/
``to_flax_params``, one layout for the whole family: ``DenseGeneral`` head
kernels ``[D, H, hd]`` <-> ``Linear`` ``[H*hd, D]``, the output projection
``[H, hd, D]`` <-> ``[D, H*hd]``, the patch conv HWIO <-> OIHW, the CLIP logit
scale ``()`` <-> ``[1]``). Inputs are made with numpy from a seed; everything
is fp32 at small widths; outputs are held within ``TOL`` (tests/
test_kernel_numerics.py's fp32 bounds) and gradients within ``REL_TOL`` in norm
over the whole tree.

- The encoder's dot and flash paths (the flash kernels' plain versions on the
  CPU), causal and not, with a padding keep-mask: outputs at real positions,
  parameter and input gradients. Passing ``mask_bias`` and ``keep_mask``
  raises; ``remat`` equals no remat, dropout included.
- BERT: MLM logits, ``mlm_loss`` and the gradients on both paths, the
  classifier; the padded flash model equals the dot model at real positions.
- ViT with ``cls`` and ``gap`` pooling and as a feature extractor.
- CLIP's forward and ``clip_loss`` with gradients; the EOT read at the first
  argmax.
- ``encoder_partition_rules`` give the reference's specs for BERT, ViT and
  CLIP on ``data=2,fsdp=4``, the type table's relocated ``(None, "fsdp")``
  included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmlcloud_tpu.models import bert as jb
from dmlcloud_tpu.models import clip as jc
from dmlcloud_tpu.models import encoder as je
from dmlcloud_tpu.models import vit as jv
from dmlcloud_tpu.parallel import mesh as jmesh
from dmlcloud_tpu_torch.models import bert as tb
from dmlcloud_tpu_torch.models import clip as tc
from dmlcloud_tpu_torch.models import encoder as te
from dmlcloud_tpu_torch.models import vit as tv
from dmlcloud_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

#: tests/test_kernel_numerics.py:28, fp32
TOL = dict(atol=5e-5, rtol=5e-5)
REL_TOL = 1e-4

ENC = dict(hidden_dim=32, num_layers=2, num_heads=2, mlp_dim=64)
BERT = dict(vocab_size=128, max_seq_len=32, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128)
VIT = dict(image_size=32, patch_size=8, hidden_dim=64, num_layers=2, num_heads=4, mlp_dim=128)
CLIP_V = dict(image_size=16, patch_size=8, hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64, num_classes=0)
CLIP_T = dict(vocab_size=64, max_seq_len=12, hidden_dim=32, num_layers=1, num_heads=2, mlp_dim=64)


def _np(tree) -> dict:
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params: dict, seed: int, scale: float = 0.05) -> dict:
    """The flax init moved off its zeros and ones, so that every leaf matters."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda a: (np.asarray(a) + scale * rng.randn(*a.shape)).astype(np.float32), params)


def _tree_rel(got: dict, want: dict) -> float:
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    return float(np.sqrt(sum(np.sum((np.asarray(a) - np.asarray(b)) ** 2) for a, b in zip(g, w))
                         / sum(np.sum(np.asarray(b) ** 2) for b in w)))


def _grads(model: torch.nn.Module, bridge) -> dict:
    return bridge.to_flax_params(model, {n: p.grad for n, p in model.named_parameters()})


# ---------------------------------------------------------------------------
# the encoder core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["dot", "flash"])
@pytest.mark.parametrize("causal", [False, True])
def test_encoder_matches_jax_with_gradients(impl, causal):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, ENC["hidden_dim"]).astype(np.float32)
    keep = np.ones((2, 64), np.int32)
    keep[1, 40:] = 0
    mask = None if causal else keep
    w = rng.randn(*x.shape).astype(np.float32)
    jcfg = je.EncoderConfig(dtype=jnp.float32, causal=causal, attn_impl=impl, **ENC)
    params = _perturbed(je.TransformerEncoder(jcfg).init(jax.random.PRNGKey(1), x)["params"], 2)
    # the pad rows' outputs differ between the paths (masked downstream): only real rows count
    real = np.ones_like(w) if causal else keep[..., None].astype(np.float32)

    def loss(p, x):
        out = je.TransformerEncoder(jcfg).apply({"params": p}, x, keep_mask=mask)
        return jnp.sum(out * w * real), out

    (_, want), (jg, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, x)
    model = te.TransformerEncoder(te.EncoderConfig(dtype=torch.float32, causal=causal, attn_impl=impl, **ENC))
    te.load_flax_params(model, params)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = model(tx, keep_mask=None if mask is None else torch.from_numpy(mask))
    (out * torch.from_numpy(w * real)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy() * real, np.asarray(want) * real, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    assert _tree_rel(_grads(model, te), jg) <= REL_TOL


def test_encoder_refuses_both_masks_and_bad_configs():
    cfg = te.EncoderConfig(dtype=torch.float32, **ENC)
    model = te.TransformerEncoder(cfg)
    x = torch.zeros(1, 8, ENC["hidden_dim"])
    keep = torch.ones(1, 8, dtype=torch.int32)
    for impl in ("dot", "flash"):
        model = te.TransformerEncoder(dataclasses.replace(cfg, attn_impl=impl))
        with pytest.raises(ValueError, match="either mask_bias or keep_mask"):
            model(x, mask_bias=te.padding_mask_bias(keep), keep_mask=keep)
    with pytest.raises(ValueError, match="attn_impl"):
        te.EncoderConfig(attn_impl="flsh")
    with pytest.raises(ValueError, match="exceeds max_len"):
        te.AddLearnedPositions(4, 8)(torch.zeros(1, 5, 8))


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_equals_no_remat(dropout):
    cfg = te.EncoderConfig(dtype=torch.float32, dropout_rate=dropout, **ENC)
    torch.manual_seed(0)
    plain = te.TransformerEncoder(cfg, dropout_seed=5)
    remat = te.TransformerEncoder(dataclasses.replace(cfg, remat=True), dropout_seed=5)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 16, ENC["hidden_dim"], generator=torch.Generator().manual_seed(1))
    outs = []
    for model in (plain, remat):
        xi = x.clone().requires_grad_(True)
        out = model(xi)
        out.square().sum().backward()
        outs.append((out.detach(), xi.grad, [p.grad for p in model.parameters()]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(outs[0][2], outs[1][2]):
        assert torch.equal(a, b)
    if dropout:
        plain.eval()
        assert not torch.equal(plain(x), outs[0][0]), "dropout drew no mask"


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------

def _bert_batch():
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, BERT["vocab_size"], (2, 16))
    mask = np.ones((2, 16), np.int32)
    mask[0, 10:] = 0
    labels = np.where((rng.rand(2, 16) < 0.5) & (mask > 0), tokens, jb.IGNORE_INDEX)
    return tokens, mask, labels


@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_bert_mlm_logits_loss_and_gradients_match_jax(impl):
    tokens, mask, labels = _bert_batch()
    jm = jb.BertForMaskedLM(jb.BertConfig(dtype=jnp.float32, attn_impl=impl, **BERT))
    params = _perturbed(jm.init(jax.random.PRNGKey(1), tokens)["params"], 4)

    def loss(p):
        logits = jm.apply({"params": p}, tokens, attention_mask=mask)
        return jb.mlm_loss(logits, labels), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = tb.BertForMaskedLM(tb.BertConfig(dtype=torch.float32, attn_impl=impl, **BERT), device="cpu")
    tb.load_flax_params(model, params)
    logits = model(torch.from_numpy(tokens), torch.from_numpy(mask))
    tl = tb.mlm_loss(logits, torch.from_numpy(labels))
    tl.backward()
    real = mask > 0
    np.testing.assert_allclose(logits.detach().numpy()[real], np.asarray(jlogits)[real], **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    assert _tree_rel(_grads(model, tb), jg) <= REL_TOL


def test_mlm_loss_ignores_masked_positions_like_the_reference():
    logits = np.zeros((1, 4, 8), np.float32)
    logits[0, 0, 3] = 100.0
    labels = np.full((1, 4), jb.IGNORE_INDEX)
    assert float(tb.mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels))) == 0.0
    labels[0, 0] = 3
    rng = np.random.RandomState(5)
    rand = rng.randn(2, 6, 8).astype(np.float32)
    lab = np.where(rng.rand(2, 6) < 0.5, rng.randint(0, 8, (2, 6)), jb.IGNORE_INDEX)
    for lg, lb in ((logits, labels), (rand, lab)):
        np.testing.assert_allclose(float(tb.mlm_loss(torch.from_numpy(lg), torch.from_numpy(lb))),
                                   float(jb.mlm_loss(jnp.asarray(lg), jnp.asarray(lb))), **TOL)


def test_bert_classifier_matches_jax_and_flash_equals_dot_at_real_positions():
    tokens, mask, _ = _bert_batch()
    jm = jb.BertForSequenceClassification(jb.BertConfig(dtype=jnp.float32, **BERT), num_classes=3)
    params = _perturbed(jm.init(jax.random.PRNGKey(2), tokens)["params"], 6)
    want = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, tokens, attention_mask=mask))(params))
    outs = {}
    for impl in ("dot", "flash"):
        model = tb.BertForSequenceClassification(tb.BertConfig(dtype=torch.float32, attn_impl=impl, **BERT),
                                                 num_classes=3, device="cpu")
        tb.load_flax_params(model, params)
        outs[impl] = model(torch.from_numpy(tokens), torch.from_numpy(mask)).detach().numpy()
        hidden = model.bert(torch.from_numpy(tokens), torch.from_numpy(mask)).detach().numpy()
        outs[impl + " hidden"] = hidden[mask > 0]
        np.testing.assert_allclose(outs[impl], want, **TOL)
    np.testing.assert_allclose(outs["flash hidden"], outs["dot hidden"], **TOL)


# ---------------------------------------------------------------------------
# ViT and CLIP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooling,classes", [("cls", 10), ("gap", 10), ("cls", 0), ("gap", 0)])
def test_vit_matches_jax(pooling, classes):
    rng = np.random.RandomState(7)
    images = rng.rand(2, 32, 32, 3).astype(np.float32)
    jm = jv.ViT(jv.ViTConfig(num_classes=classes, pooling=pooling, dtype=jnp.float32, **VIT))
    params = _perturbed(jm.init(jax.random.PRNGKey(3), images)["params"], 8)
    w = rng.randn(2, classes or VIT["hidden_dim"]).astype(np.float32)
    (_, want), jg = jax.jit(jax.value_and_grad(lambda p: (jnp.sum(jm.apply({"params": p}, images) * w),
                                                          jm.apply({"params": p}, images)), has_aux=True))(params)
    model = tv.ViT(tv.ViTConfig(num_classes=classes, pooling=pooling, dtype=torch.float32, **VIT), device="cpu")
    tv.load_flax_params(model, params)
    out = model(torch.from_numpy(images))
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == (2, classes or VIT["hidden_dim"])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **TOL)
    assert _tree_rel(_grads(model, tv), jg) <= REL_TOL


def _clip_configs():
    jcfg = jc.CLIPConfig(embed_dim=32, vision=jv.ViTConfig(dtype=jnp.float32, **CLIP_V),
                         text=jc.CLIPTextConfig(dtype=jnp.float32, **CLIP_T))
    tcfg = tc.CLIPConfig(embed_dim=32, vision=tv.ViTConfig(dtype=torch.float32, **CLIP_V),
                         text=tc.CLIPTextConfig(dtype=torch.float32, **CLIP_T))
    return jcfg, tcfg


def test_clip_forward_loss_and_gradients_match_jax():
    rng = np.random.RandomState(9)
    images = rng.rand(4, 16, 16, 3).astype(np.float32)
    tokens = rng.randint(1, 63, (4, 12))
    tokens[:, -1] = 63
    tokens[0, 4] = 63  # two EOT ids in a row: the first one counts
    jcfg, tcfg = _clip_configs()
    jm = jc.CLIP(jcfg)
    params = _perturbed(jm.init(jax.random.PRNGKey(4), images, tokens)["params"], 10, scale=0.02)

    def loss(p):
        img, txt, scale = jm.apply({"params": p}, images, tokens)
        return jc.clip_loss(img, txt, scale), (img, txt, scale)

    (jl, (jimg, jtxt, jscale)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    model = tc.CLIP(tcfg, device="cpu")
    tc.load_flax_params(model, params)
    img, txt, scale = model(torch.from_numpy(images), torch.from_numpy(tokens))
    tl = tc.clip_loss(img, txt, scale)
    tl.backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), **TOL)
    np.testing.assert_allclose(txt.detach().numpy(), np.asarray(jtxt), **TOL)
    np.testing.assert_allclose(float(scale), float(jscale), **TOL)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(np.linalg.norm(img.detach().numpy(), axis=-1), 1.0, atol=1e-5)
    assert _tree_rel(_grads(model, tc), jg) <= REL_TOL
    back = tc.to_flax_params(model)
    assert back["log_logit_scale"].shape == () and tuple(model.log_logit_scale.shape) == (1,)


# ---------------------------------------------------------------------------
# the partition rules
# ---------------------------------------------------------------------------

def _reference_specs(shapes, axes: dict) -> dict[str, tuple]:
    n = int(np.prod(list(axes.values())))
    mesh = jmesh.create_mesh(axes, devices=jax.devices()[:n])
    fn = jmesh.make_param_policy(je.encoder_partition_rules())
    return {jmesh.path_str(path): tuple(fn(jmesh.path_str(path), leaf, mesh))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("family", ["bert", "vit", "clip"])
def test_partition_rules_give_the_references_specs(family):
    axes = {"data": 2, "fsdp": 4}
    if family == "bert":
        tokens = jnp.zeros((1, 16), jnp.int32)
        shapes = jax.eval_shape(jb.BertForMaskedLM(jb.BertConfig(dtype=jnp.float32, **BERT)).init,
                                jax.random.PRNGKey(0), tokens)["params"]
        model = tb.BertForMaskedLM(tb.BertConfig(dtype=torch.float32, **BERT), device="cpu")
    elif family == "vit":
        shapes = jax.eval_shape(jv.ViT(jv.ViTConfig(dtype=jnp.float32, **VIT)).init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))["params"]
        model = tv.ViT(tv.ViTConfig(dtype=torch.float32, **VIT), device="cpu")
    else:
        jcfg, tcfg = _clip_configs()
        shapes = jax.eval_shape(jc.CLIP(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                jnp.zeros((1, 12), jnp.int32))["params"]
        model = tc.CLIP(tcfg, device="cpu")
    want = _reference_specs(shapes, axes)
    got = tmesh.sharding_for(model, axes, te.encoder_partition_rules())
    assert set(got) == set(want)
    for path in want:
        assert tuple(got[path]) == want[path], f"{path}: port {got[path]}, reference {want[path]}"
    if family == "bert":
        assert want["bert/embeddings/type/embedding"] == (None, "fsdp")  # 2 rows: relocated
        assert want["bert/embeddings/word/embedding"][0] == "fsdp"
