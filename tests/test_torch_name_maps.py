"""The port's lineage name maps (objgan_tpu_torch/core/name_maps.py) and
state-dict converters (core/checkpoint.py) against the JAX package's
(objgan_tpu/core/name_maps.py, core/checkpoint.py): every map names the
port parameter that JAX's names (its flax path, ``/`` as ``.``, ``kernel``
as ``weight``); the same random lineage state dict loaded by both packages
gives the port the state dict ``core/bridge.py::jax_to_torch`` makes of
JAX's params, exactly, with equal reports; the RNN encoder computes what a
lineage ``nn.Embedding`` + ``nn.LSTM`` computes (atol 1e-5); and the
converter's rules (the LSTM bias pair summed, any other shared target
refused, the embedding untransposed, a 1x1 conv squeezed onto a Dense)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.core import checkpoint as jckpt
from objgan_tpu.core import name_maps as jmaps
from objgan_tpu.models.damsm import RNNEncoder as JRNNEncoder
from objgan_tpu.models.discriminator import DNet as JDNet
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core import checkpoint as tckpt
from objgan_tpu_torch.core import name_maps as tmaps
from objgan_tpu_torch.core.layers import Dense, init_weights
from objgan_tpu_torch.models.damsm import RNNEncoder
from objgan_tpu_torch.models.discriminator import DNet
from objgan_tpu_torch.models.generator import GNet
from objgan_tpu_torch.models.inception_v3 import (InceptionEncoder,
                                                  torchvision_state_dict)
from tests.torch_parity import jax_stage_params, port_cfg, tiny

torch.set_num_threads(2)


def _port_name(flax_path):
    *mods, leaf = flax_path.split("/")
    return ".".join(mods + [bridge._to_torch(leaf, np.zeros((1, 1)))[0]])


def _lineage_sd(module, name_map, seed, skip=()):
    """A random lineage state dict for every map entry whose target
    ``module`` has: torch layouts, the LSTM's (4H, D), a 1x1 conv where
    the target is a Dense weight and the lineage has a conv."""
    r = np.random.default_rng(seed)
    state = module.state_dict()
    sd = {}
    for tname, pname in name_map.items():
        if pname not in state or tname in skip:
            continue
        shape = tuple(state[pname].shape)
        if "weight_ih" in tname or "weight_hh" in tname:
            shape = shape[::-1]
        elif "conv_context" in tname:
            shape = shape + (1, 1)
        sd[tname] = torch.from_numpy(
            r.standard_normal(shape).astype(np.float32))
    return sd


def _assert_state_equal(module, jax_params):
    got = {k: v.numpy() for k, v in module.state_dict().items()}
    want = bridge.jax_to_torch(jax.device_get(jax_params))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# -- the maps name the same parameters ---------------------------------------


def _maps(cfg):
    pc = port_cfg(cfg)
    yield "rnn", tmaps.rnn_encoder_name_map(), jmaps.rnn_encoder_name_map()
    yield "bilstm", tmaps.bilstm_name_map("x.", "y."), \
        jmaps.bilstm_name_map("x.", "y/")
    for c in (cfg, cfg.merged({"TREE": {"BASE_SIZE": 64}, "GAN": {
            "R_NUM": 3}})):
        yield "g", tmaps.g_net_name_map(port_cfg(c)), jmaps.g_net_name_map(c)
    for size in (64, 128, 256):
        yield f"d{size}", tmaps.d_net_name_map(pc, size), \
            jmaps.d_net_name_map(cfg, size)
    names = [k for k in torchvision_state_dict(InceptionEncoder(8))
             if not k.startswith("fc.")]
    names += ["emb_features.weight", "emb_cnn_code.weight",
              "emb_cnn_code.bias", "Conv2d_1a_3x3.bn.num_batches_tracked"]
    yield "cnn", tmaps.cnn_encoder_name_map(names), \
        jmaps.cnn_encoder_name_map(names)


def test_maps_name_what_jax_maps_name():
    for tag, port_map, jax_map in _maps(tiny()):
        assert set(port_map) == set(jax_map), tag
        for tname, path in jax_map.items():
            want = _port_name(path.replace("y/", "y."))
            assert port_map[tname] == want, (tag, tname)


# -- the same lineage dict, loaded by both packages --------------------------


def test_g_net_partial_load_matches_jax():
    cfg = tiny()
    pc = port_cfg(cfg)
    jparams = jax_stage_params(cfg)["gan_g"]
    g = GNet(pc)
    bridge.load_jax_params(g, jparams)
    k = tuple(g.state_dict()["init_stage.up1.conv.weight"].shape)
    sd = _lineage_sd(g, tmaps.g_net_name_map(pc), seed=1)
    # the lineage's first up-block has no layout channels: fewer inputs
    sd["h_net1.upsample1.1.weight"] = torch.zeros(k[0], 4, k[2], k[3])
    sd["h_net1.upsample1.2.weight"] = torch.zeros(4)
    sd["h_net1.upsample1.2.running_mean"] = torch.zeros(4)
    sd["h_net1.upsample1.2.running_var"] = torch.ones(4)
    sd["h_net1.upsample1.2.num_batches_tracked"] = torch.tensor(3)
    sd["some_objgan_extra.weight"] = torch.zeros(3, 3)
    sd["h_net9.att.conv_context.weight"] = torch.zeros(2, 2, 1, 1)

    jp, jrep = jmaps.load_lineage_partial(jparams, sd,
                                          jmaps.g_net_name_map(cfg))
    g, trep = tmaps.load_lineage_partial(g, sd, tmaps.g_net_name_map(pc))
    assert trep == jrep
    _assert_state_equal(g, jp)
    assert "ca_net.fc.weight" in trep["loaded"]
    assert "h_net2.att.conv_context.weight" in trep["loaded"]
    assert "h_net1.upsample1.1.weight" in trep["skipped_shape"]
    assert len(trep["skipped_bn"]) == 4
    assert trep["unmapped"] == ["some_objgan_extra.weight",
                                "h_net9.att.conv_context.weight"]
    # the 1x1 conv squeezed onto the Dense word projection, untransposed
    np.testing.assert_array_equal(
        g.attn_stage1.word_proj.weight.detach().numpy(),
        sd["h_net2.att.conv_context.weight"].numpy()[:, :, 0, 0])


@pytest.mark.parametrize("size", [64, 128, 256])
def test_d_net_partial_load_matches_jax(size):
    cfg = tiny()
    pc = port_cfg(cfg)
    jd = JDNet(cfg.GAN.DF_DIM, size)
    jparams = jax.device_get(jax.jit(jd.init)(
        jax.random.PRNGKey(size), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, cfg.TEXT.EMBEDDING_DIM)), jnp.zeros((1, size, size,
                                                          1))))
    d = DNet(pc.GAN.DF_DIM, size, pc.TEXT.EMBEDDING_DIM)
    bridge.load_jax_params(d, jparams)
    sd = _lineage_sd(d, tmaps.d_net_name_map(pc, size), seed=size)
    first = tuple(d.state_dict()["down_blocks_0.Conv_0.weight"].shape)
    sd["img_code_s16.0.weight"] = torch.zeros(first[0], 3, *first[2:])
    sd["img_code_s16.3.running_var"] = torch.ones(first[0])
    sd["img_code_s16.3.weight"] = torch.ones(first[0])
    sd["img_code_s16.3.running_mean"] = torch.ones(first[0])
    if size == 64:  # a D_NET128 entry given to the 64 px net
        sd["img_code_s32.0.weight"] = torch.zeros(1)
    jp, jrep = jmaps.load_lineage_partial(
        jparams, sd, jmaps.d_net_name_map(cfg, size))
    d, trep = tmaps.load_lineage_partial(d, sd, tmaps.d_net_name_map(pc,
                                                                     size))
    assert trep == jrep
    _assert_state_equal(d, jp)
    assert "img_code_s16.0.weight" in trep["unmapped"]
    assert "COND_DNET.outlogits.0.bias" in trep["loaded"]
    assert trep["skipped_shape"] == [] and len(trep["skipped_bn"]) == 3


def _lineage_text_modules(vocab=30, d=8, h=4, seed=0):
    torch.manual_seed(seed)
    emb = torch.nn.Embedding(vocab, d)
    lstm = torch.nn.LSTM(d, h, batch_first=True, bidirectional=True)
    sd = {"encoder." + k: v for k, v in emb.state_dict().items()}
    sd.update({"rnn." + k: v for k, v in lstm.state_dict().items()})
    return emb, lstm, sd


def test_rnn_encoder_load_matches_jax_and_lineage_forward():
    vocab, d, h, t = 30, 8, 4, 5
    emb, lstm, sd = _lineage_text_modules(vocab, d, h)
    assert set(sd) == set(tmaps.rnn_encoder_name_map())
    caps = np.array([[3, 5, 7, 2, 9], [4, 4, 1, 0, 0], [8, 0, 0, 0, 0]],
                    np.int32)
    lens = np.array([5, 3, 1], np.int32)
    jparams = jax.device_get(JRNNEncoder(vocab_size=vocab, embed_dim=d,
                                         hidden_dim=h).init(
        jax.random.PRNGKey(0), jnp.asarray(caps), jnp.asarray(lens)))
    enc = RNNEncoder(vocab, d, h)
    init_weights(enc, torch.Generator().manual_seed(5))
    tmaps.load_rnn_encoder_checkpoint(enc, sd)
    _assert_state_equal(enc, jmaps.load_rnn_encoder_checkpoint(jparams, sd))

    with torch.no_grad():
        x = emb(torch.from_numpy(caps).long())
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            x, torch.from_numpy(lens).long(), batch_first=True,
            enforce_sorted=False)
        out, (hn, _) = lstm(packed)
        out, _ = torch.nn.utils.rnn.pad_packed_sequence(
            out, batch_first=True, total_length=t)
        words, sent = enc.eval()(torch.from_numpy(caps).long(),
                                 torch.from_numpy(lens).long())
    np.testing.assert_allclose(words.numpy(), out.numpy(), atol=1e-5)
    np.testing.assert_allclose(sent.numpy(),
                               torch.cat([hn[0], hn[1]], -1).numpy(),
                               atol=1e-5)


def test_cnn_encoder_load_matches_jax():
    src, dst = InceptionEncoder(16), InceptionEncoder(16)
    init_weights(src, torch.Generator().manual_seed(1))
    init_weights(dst, torch.Generator().manual_seed(2))
    r = np.random.default_rng(3)
    sd = {k: v + torch.from_numpy(r.standard_normal(tuple(v.shape))
                                  .astype(np.float32)) * 0.1
          for k, v in torchvision_state_dict(src).items()
          if not k.startswith("fc.")}
    sd.update({"emb_features.weight": src.emb_features.weight.detach(),
               "emb_cnn_code.weight": src.emb_cnn_code.weight.detach(),
               "emb_cnn_code.bias": torch.ones(16),
               "Mixed_6e.branch1x1.bn.num_batches_tracked": torch.tensor(7),
               "AuxLogits.fc.weight": torch.zeros(1000, 768)})
    jparams = {"params": bridge.torch_to_jax(dst)}
    jp = jmaps.load_cnn_encoder_checkpoint(jparams, sd)
    tmaps.load_cnn_encoder_checkpoint(dst, sd)
    _assert_state_equal(dst, jp)
    assert torch.equal(dst.emb_cnn_code.bias, torch.ones(16))


# -- the converter's rules ---------------------------------------------------


def test_lstm_weights_transposed_bias_pair_summed():
    h, d = 4, 6
    sd = {"rnn.weight_ih_l0": torch.randn(4 * h, d),
          "rnn.weight_hh_l0": torch.randn(4 * h, h),
          "rnn.bias_ih_l0": torch.arange(4 * h, dtype=torch.float32),
          "rnn.bias_hh_l0": torch.ones(4 * h)}
    m = {k: v for k, v in tmaps.bilstm_name_map("rnn.", "").items()
         if not k.endswith("_reverse")}
    out = tckpt.convert_torch_state_dict(sd, m)
    assert torch.equal(out["fwd_w_ih"], sd["rnn.weight_ih_l0"].t())
    assert torch.equal(out["fwd_w_hh"], sd["rnn.weight_hh_l0"].t())
    assert torch.equal(out["fwd_b"], torch.arange(4 * h) + 1.0)
    jm = {k: v for k, v in jmaps.bilstm_name_map("rnn.", "").items()
          if not k.endswith("_reverse")}
    jout = jckpt.convert_torch_state_dict(sd, jm)
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), jout[k])


def test_other_shared_target_and_unmapped_name_raise():
    sd = {"a.weight": torch.zeros(2, 2), "b.weight": torch.zeros(2, 2)}
    with pytest.raises(ValueError, match="map to port name"):
        tckpt.convert_torch_state_dict(sd, {"a.weight": "x",
                                            "b.weight": "x"})
    with pytest.raises(KeyError, match="no mapping"):
        tckpt.convert_torch_state_dict(sd, {"a.weight": "x"})


def test_embedding_and_linear_untransposed():
    sd = {"encoder.weight": torch.randn(30, 8),
          "fc.weight": torch.randn(5, 3)}
    out = tckpt.convert_torch_state_dict(
        sd, {"encoder.weight": "embedding.weight", "fc.weight": "fc.weight"})
    assert torch.equal(out["embedding.weight"], sd["encoder.weight"])
    assert torch.equal(out["fc.weight"], sd["fc.weight"])


def test_one_by_one_conv_squeezed_onto_dense():
    net = torch.nn.Module()
    net.proj = Dense(6, 4, bias=False)
    conv = torch.randn(4, 6, 1, 1)
    _, rep = tmaps.load_lineage_partial(net, {"ctx.weight": conv},
                                        {"ctx.weight": "proj.weight"})
    assert rep["loaded"] == ["ctx.weight"]
    assert torch.equal(net.proj.weight.detach(), conv[:, :, 0, 0])
    _, rep = tmaps.load_lineage_partial(
        net, {"ctx.weight": torch.randn(4, 5, 1, 1),
              "gone.weight": torch.zeros(1)},
        {"ctx.weight": "proj.weight", "gone.weight": "nowhere.weight"})
    assert rep["skipped_shape"] == ["ctx.weight"]
    assert rep["missing_target"] == ["gone.weight"]


def test_apply_converted_requires_names_and_shapes():
    net = torch.nn.Module()
    net.proj = Dense(3, 2)
    with pytest.raises(KeyError, match="not found"):
        tckpt.apply_converted(net, {"proj.nothing": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.apply_converted(net, {"proj.weight": torch.zeros(3, 2)})


def test_split_convertible_matches_jax():
    sd = {"a.weight": torch.zeros(2, 2, 3, 3), "bn.weight": torch.zeros(2),
          "bn.running_mean": torch.zeros(2), "bn.bias": torch.zeros(2),
          "other.bias": torch.zeros(2)}
    m = {"a.weight": "a.weight"}
    got = tmaps.split_convertible(sd, m)
    want = jmaps.split_convertible(sd, m)
    assert list(got[0]) == list(want[0]) and got[1:] == want[1:]
    assert got[1] == ["bn.weight", "bn.running_mean", "bn.bias"]
    assert got[2] == ["other.bias"]
