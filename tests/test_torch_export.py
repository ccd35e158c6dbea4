"""The lineage tools of the port (objgan_tpu_torch/tools/convert_damsm.py,
convert_gan.py, export_damsm.py) and the export direction of the name maps
against the JAX package's: each package's export of the same weights equals
the other's, bit for bit; a port export imports into JAX exactly and a JAX
export into the port; ``convert_damsm`` writes a checkpoint that
``cli.load_damsm_encoders`` (``TRAIN.NET_E``) loads; ``convert_gan`` one
that ``cli.sample_gan`` (``TRAIN.NET_G``) samples from; ``export_damsm``
round-trips a converted checkpoint and refuses the lite backbone; a file
that needs pickle code to load is refused."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objgan_tpu.core import name_maps as jmaps
from objgan_tpu.models.damsm import RNNEncoder as JRNNEncoder
from objgan_tpu_torch import cli
from objgan_tpu_torch.core import bridge
from objgan_tpu_torch.core import name_maps as tmaps
from objgan_tpu_torch.core.checkpoint import CheckpointManager
from objgan_tpu_torch.core.layers import init_weights
from objgan_tpu_torch.models.damsm import RNNEncoder
from objgan_tpu_torch.models.inception_v3 import InceptionEncoder
from objgan_tpu_torch.tools import convert_damsm, convert_gan, export_damsm
from objgan_tpu_torch.train.gan import GanTrainer
from tests.test_torch_name_maps import (_assert_state_equal, _lineage_sd,
                                        _lineage_text_modules)
from tests.torch_parity import ttiny

torch.set_num_threads(2)

# tiny_test_config's text dims: vocab 50, GloVe 16, hidden 16 per direction
VOCAB, GLOVE, HIDDEN = 50, 16, 16


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def text_pair():
    """A JAX ``RNNEncoder``'s params and the port's encoder holding them."""
    caps = jnp.ones((2, 5), jnp.int32)
    jparams = jax.device_get(JRNNEncoder(vocab_size=30, embed_dim=8,
                                         hidden_dim=4).init(
        jax.random.PRNGKey(1), caps, jnp.ones((2,), jnp.int32)))
    enc = RNNEncoder(30, 8, 4)
    bridge.load_jax_params(enc, jparams)
    return jparams, enc


@pytest.fixture(scope="module")
def image_pair():
    enc = InceptionEncoder(16)
    init_weights(enc, torch.Generator().manual_seed(4))
    with torch.no_grad():  # statistics other than the fresh 0 / 1
        enc.backbone.Mixed_5b.branch1x1.bn_mean.fill_(0.25)
    return {"params": bridge.torch_to_jax(enc)}, enc


def test_text_exports_equal(text_pair):
    jparams, enc = text_pair
    _equal_dicts(tmaps.export_rnn_encoder(enc),
                 jmaps.export_rnn_encoder(jparams))


def test_image_exports_equal(image_pair):
    jparams, enc = image_pair
    got = tmaps.export_cnn_encoder(enc)
    _equal_dicts(got, jmaps.export_cnn_encoder(jparams))
    assert not any(k.startswith("fc.") for k in got)
    assert got["Mixed_5b.branch1x1.bn.num_batches_tracked"].dtype == \
        torch.int64


def test_round_trips_across_packages(text_pair, image_pair):
    """port export -> JAX import and JAX export -> port import, exact."""
    jparams, enc = text_pair
    other = jax.tree.map(np.zeros_like, jparams)
    _assert_state_equal(enc, jmaps.load_rnn_encoder_checkpoint(
        other, tmaps.export_rnn_encoder(enc)))
    fresh = RNNEncoder(30, 8, 4)
    tmaps.load_rnn_encoder_checkpoint(fresh, {
        k: torch.from_numpy(np.array(v))
        for k, v in jmaps.export_rnn_encoder(jparams).items()})
    _assert_state_equal(fresh, jparams)

    jparams, enc = image_pair
    other = jax.tree.map(np.zeros_like, jparams)
    restored = jmaps.load_cnn_encoder_checkpoint(
        other, tmaps.export_cnn_encoder(enc))
    want = bridge.jax_to_torch(jax.device_get(restored))
    for k, v in enc.state_dict().items():
        if not k.startswith("backbone.fc."):  # the lineage has no fc
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    fresh = InceptionEncoder(16)
    tmaps.load_cnn_encoder_checkpoint(fresh, {
        k: torch.from_numpy(np.array(v))
        for k, v in jmaps.export_cnn_encoder(jparams).items()})
    for k, v in fresh.state_dict().items():
        if not k.startswith("backbone.fc."):
            assert torch.equal(v, enc.state_dict()[k]), k


def _text_pth(tmp_path, seed=0):
    _, _, sd = _lineage_text_modules(VOCAB, GLOVE, HIDDEN, seed)
    path = str(tmp_path / "text_encoder.pth")
    torch.save(sd, path)
    return path, sd


def test_convert_damsm_to_net_e_and_export_back(tmp_path):
    text_pth, text_sd = _text_pth(tmp_path)
    src = InceptionEncoder(2 * HIDDEN)
    init_weights(src, torch.Generator().manual_seed(6))
    img_sd = tmaps.export_cnn_encoder(src)
    img_pth = str(tmp_path / "image_encoder.pth")
    torch.save({"state_dict": img_sd}, img_pth)  # a wrapped state dict
    cfg = ttiny().replace(OUTPUT_DIR=str(tmp_path / "out"))
    out = str(tmp_path / "net_e")
    convert_damsm.main(["--text_pth", text_pth, "--image_pth", img_pth,
                        "--out", out, "--cfg", _yml(tmp_path, cfg)])
    net_cfg = cfg.merged({"TRAIN": {"NET_E": out},
                          "TEXT": {"CNN_BACKBONE": "inception"}})
    text_state, img_state = cli.load_damsm_encoders(net_cfg)
    assert text_state is not None
    enc = RNNEncoder(VOCAB, GLOVE, HIDDEN)
    tmaps.load_rnn_encoder_checkpoint(enc, text_sd)
    _equal_dicts(text_state, enc.state_dict())
    for k, v in src.state_dict().items():
        if not k.startswith("backbone.fc."):  # the lineage has no fc
            assert torch.equal(img_state[k], v), k
    # and back out, exactly as the lineage files went in
    exp_text, exp_img = str(tmp_path / "t.pth"), str(tmp_path / "i.pth")
    export_damsm.main(["--ckpt", out, "--text_pth", exp_text,
                       "--image_pth", exp_img,
                       "--cfg", _yml(tmp_path, net_cfg)])
    got = torch.load(exp_text, weights_only=True)
    assert set(got) == set(text_sd)
    for k in text_sd:
        if "bias" not in k:
            assert torch.equal(got[k], text_sd[k]), k
    for d in ("", "_reverse"):
        summed = (text_sd[f"rnn.bias_ih_l0{d}"]
                  + text_sd[f"rnn.bias_hh_l0{d}"])
        assert torch.equal(got[f"rnn.bias_ih_l0{d}"], summed)
        assert not got[f"rnn.bias_hh_l0{d}"].any()
    _equal_dicts(torch.load(exp_img, weights_only=True), img_sd)


def _yml(tmp_path, cfg):
    """``cfg`` written as a yml the entry points read."""
    import dataclasses

    import yaml

    path = str(tmp_path / f"cfg{len(os.listdir(tmp_path))}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
    return path


def test_convert_gan_to_net_g_and_sample(tmp_path, capsys):
    text_pth, _ = _text_pth(tmp_path, seed=1)
    net_e = str(tmp_path / "net_e")
    cfg = ttiny().replace(OUTPUT_DIR=str(tmp_path / "out"))
    convert_damsm.convert(cfg, text_pth, None, net_e)
    cfg = cfg.merged({"TRAIN": {"NET_E": net_e, "FLAG": False}})
    template = GanTrainer(cfg)
    g_sd = _lineage_sd(template.g_net, tmaps.g_net_name_map(cfg), seed=2)
    torch.save(g_sd, str(tmp_path / "netG.pth"))
    d_pths = []
    for dnet, size in zip(template.d_nets, cfg.branch_sizes):
        d_pths.append(str(tmp_path / f"netD{size}.pth"))
        torch.save(_lineage_sd(dnet, tmaps.d_net_name_map(cfg, size),
                               seed=size), d_pths[-1])
    net_g = str(tmp_path / "net_g")
    with pytest.raises(SystemExit, match="once per pyramid scale"):
        convert_gan.convert(cfg, None, d_pths[:1], net_g)
    capsys.readouterr()
    convert_gan.convert(cfg, str(tmp_path / "netG.pth"), d_pths, net_g)
    printed = capsys.readouterr().out
    assert "loaded pretrained DAMSM encoders" in printed
    assert "G_NET: loaded" in printed and "D_NET64: loaded" in printed
    trainer = GanTrainer(cfg)
    assert CheckpointManager(net_g).restore_latest(trainer) == 0
    for net in (trainer.g_net, trainer.ema_g):
        assert torch.equal(net.ca_net.fc.weight, g_sd["ca_net.fc.weight"])
    assert torch.equal(trainer.d_nets[2].cond_logits.weight,
                       torch.load(d_pths[2])["COND_DNET.outlogits.0.weight"])
    enc_state, _ = cli.load_damsm_encoders(cfg)
    _equal_dicts(trainer.text_enc.state_dict(), enc_state)

    out = cli.sample_gan(cfg.merged({"TRAIN": {"NET_G": net_g}}),
                         num_batches=1, device="cpu")
    assert "UNTRAINED" not in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["s0_0.png", "s0_1.png"]


def test_export_damsm_refuses_the_lite_backbone(tmp_path):
    cfg = ttiny()
    assert cfg.TEXT.CNN_BACKBONE == "lite"
    with pytest.raises(SystemExit, match="InceptionLite image encoder has "
                                         "no PyTorch counterpart"):
        export_damsm.export(cfg, str(tmp_path), str(tmp_path / "t.pth"),
                            str(tmp_path / "i.pth"))
    with pytest.raises(SystemExit, match="no checkpoint found"):
        export_damsm.export(cfg, str(tmp_path / "none"),
                            str(tmp_path / "t.pth"))


class _Pickled:
    """An object torch.load can only rebuild by running pickle code."""

    def __init__(self):
        self.w = torch.zeros(2)


def test_file_needing_pickle_code_is_refused(tmp_path):
    path = str(tmp_path / "text_encoder.pth")
    torch.save({"encoder.weight": torch.zeros(3, 2), "extra": _Pickled()},
               path)
    with pytest.raises(SystemExit, match="needs pickle code"):
        convert_damsm.convert(ttiny(), path, None, str(tmp_path / "out"))
