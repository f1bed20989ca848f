"""Port parity: the weights' host path — convert, cache, fetch and the CLI.

Reference-form ``.pth`` checkpoints (unfolded BatchNorm, OIHW kernels,
``num_batches_tracked``) are made from a seed with numpy under the
released filenames, and go through the JAX package's functions and the
port's.  Archives must be equal array for array: the same keys in the same
order, the same dtypes and the same bits.  Fetches are served from
``file://`` roots in ``tmp_path``; ``tests/conftest.py`` turns the fetch
off for the suite and the tests that fetch turn it on with ``monkeypatch``.
"""

import warnings

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from face_crop_plus_tpu import convert as jconvert
from face_crop_plus_tpu.models import parsing as jp
from face_crop_plus_tpu.models import weights as jw
from face_crop_plus_tpu.ops.nn import Params
from face_crop_plus_tpu_torch import convert as tconvert
from face_crop_plus_tpu_torch.models import detection as tdet
from face_crop_plus_tpu_torch.models import enhancement as te
from face_crop_plus_tpu_torch.models import parsing as tp
from face_crop_plus_tpu_torch.models import weights as tw

from torch_parity import tamed_bisenet_params

#: The auxiliary heads of a trained ``bise_parser.pth`` that the parser
#: network lacks (training-time losses at 1/16 and 1/32).
AUX_HEAD = {
    "conv_out16.conv.conv.weight": (64, 128, 3, 3),
    "conv_out16.conv_out.weight": (19, 64, 1, 1),
}


def reference_checkpoint(net: nn.Module, rng, extra=None) -> dict[str, torch.Tensor]:
    """A raw torch state dict with ``net``'s structure, as the reference's
    checkpoints hold it: each folded BN (``.scale``/``.bias``) unfolded to
    weight, bias, running stats and ``num_batches_tracked``; conv kernels
    OIHW; ``extra`` keys (name → shape) appended."""
    sd = net.state_dict()
    bn = {k[: -len(".scale")] for k in sd if k.endswith(".scale")}
    out = {}
    for key, ref in sd.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix in bn:
            if leaf != "scale":
                continue
            c = tuple(ref.shape)
            out[f"{prefix}.weight"] = rng.uniform(0.5, 2.0, c)
            out[f"{prefix}.bias"] = rng.normal(size=c) * 0.3
            out[f"{prefix}.running_mean"] = rng.normal(size=c) * 0.1
            out[f"{prefix}.running_var"] = rng.uniform(0.1, 3.0, c)
            out[f"{prefix}.num_batches_tracked"] = np.int64(7)
        elif ref.ndim == 4:
            fan_in = np.prod(ref.shape[1:])
            out[key] = rng.normal(size=tuple(ref.shape)) / np.sqrt(fan_in)
        else:
            out[key] = rng.normal(size=tuple(ref.shape)) * 0.1
    for key, shape in (extra or {}).items():
        out[key] = rng.normal(size=shape)
    return {k: torch.as_tensor(np.asarray(v, np.int64 if np.ndim(v) == 0 else np.float32))
            for k, v in out.items()}


def bisenet_checkpoint(aux: bool = True) -> dict[str, torch.Tensor]:
    """``bise_parser.pth``, with the auxiliary head a trained one holds."""
    return reference_checkpoint(tp.BiSeNetNet(), np.random.default_rng(3),
                                AUX_HEAD if aux else None)


def assert_same_archive(ours: dict, ref: dict):
    """Equal keys in equal order, equal dtypes and shapes, equal bits."""
    assert list(ours) == list(ref)
    for k in ref:
        a, b = np.asarray(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.fixture
def no_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(tw, "_failed_url_roots", set())
    monkeypatch.setattr(jw, "_failed_url_roots", set())
    return tmp_path / "cache"


# ---------------------------------------------------------------------------
# The repair: a JAX-cached archive with keys the network lacks
# ---------------------------------------------------------------------------


def test_jax_cached_npz_with_auxiliary_head_loads(tmp_path, no_cache):
    sd = bisenet_checkpoint()
    jdir, pdir = tmp_path / "jax", tmp_path / "pth"
    jdir.mkdir()
    pdir.mkdir()
    torch.save(sd, jdir / "bise_parser.pth")
    torch.save(sd, pdir / "bise_parser.pth")
    # The JAX package converts the checkpoint and caches every key of it.
    assert jw.find_weights("bisenet", str(jdir), auto_download=False) is not None
    cached = jw.load_npz(str(jdir / "bisenet.npz"))
    assert set(AUX_HEAD) <= set(cached)
    (jdir / "bise_parser.pth").unlink()  # only the JAX archive is left to read

    net = tp.BiSeNetNet()
    assert tw.load_or_init("bisenet", net, str(jdir))
    via_pth = tp.BiSeNetNet()
    assert tw.load_or_init("bisenet", via_pth, str(pdir))
    ref = via_pth.state_dict()
    for k, v in net.state_dict().items():
        assert v.dtype == ref[k].dtype and torch.equal(v, ref[k]), k
    # from_jax_params stays strict about the same archive.
    with pytest.raises(KeyError, match="conv_out16"):
        tw.from_jax_params(cached, tp.BiSeNetNet())

    # The parser on that archive against the JAX parser on it.
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # neither may fall back to random init
        j = jp.BiSeNet(weights_dir=str(jdir))
        t = tp.BiSeNet(weights_dir=str(jdir), device="cpu")
    assert j.pretrained and t.pretrained
    x = np.random.default_rng(11).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jp.bisenet_forward(Params(j.params), jnp.asarray(x)))
    with torch.no_grad():
        got = tp.bisenet_forward(t.net, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 19)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_npz_missing_a_network_key_is_refused(tmp_path, no_cache):
    params = dict(tamed_bisenet_params())
    params.pop("ffm.conv1.weight")
    jw.save_npz(params, str(tmp_path / "bisenet.npz"))
    with pytest.raises(RuntimeError, match="ffm.conv1.weight"):
        tw.load_or_init("bisenet", tp.BiSeNetNet(), str(tmp_path))


# ---------------------------------------------------------------------------
# Conversion: the port's archive is the JAX package's, bit for bit
# ---------------------------------------------------------------------------


def _checkpoint(kind: str) -> tuple[str, dict[str, torch.Tensor]]:
    rng = np.random.default_rng(5)
    if kind == "retinaface":
        return kind, reference_checkpoint(tdet.RetinaFaceNet(), rng)
    if kind == "bisenet_aux":
        return "bisenet", bisenet_checkpoint()
    return "rrdb", reference_checkpoint(te.RRDBNetwork(2), rng)


@pytest.mark.parametrize("kind", ["retinaface", "bisenet_aux", "rrdb_2_blocks"])
def test_convert_pth_file_and_caches_equal_jax(tmp_path, no_cache, kind):
    model, sd = _checkpoint(kind)
    sd = {"state_dict": sd} if kind == "retinaface" else sd  # a wrapped checkpoint too
    fname = tw.PTH_FILENAMES[model]
    assert fname == jw.PTH_FILENAMES[model]
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        torch.save(sd, tmp_path / side / fname)

    ours = tw.convert_pth_file(str(tmp_path / "port" / fname))
    ref = jw.convert_pth_file(str(tmp_path / "jax" / fname))
    assert_same_archive(ours, ref)
    assert not any(k.endswith("num_batches_tracked") for k in ours)

    # find_weights caches the conversion next to the checkpoint: the same
    # archive on both sides.
    net = {"retinaface": tdet.RetinaFaceNet, "bisenet": tp.BiSeNetNet,
           "rrdb": lambda: te.RRDBNetwork(2)}[model]()
    found = tw.find_weights(model, str(tmp_path / "port"), net)
    assert jw.find_weights(model, str(tmp_path / "jax"), auto_download=False) is not None
    assert_same_archive(tw.load_npz(str(tmp_path / "port" / f"{model}.npz")),
                        jw.load_npz(str(tmp_path / "jax" / f"{model}.npz")))
    assert not no_cache.exists()  # nothing leaked into the global cache
    net.load_state_dict(found, strict=True)
    assert set(found) == set(net.state_dict())

    # Each package reads the other's archive.
    tw.save_npz(ours, str(tmp_path / "by_port"))  # ".npz" appended, as np.savez does
    jw.save_npz(ref, str(tmp_path / "by_jax.npz"))
    assert_same_archive(jw.load_npz(str(tmp_path / "by_port.npz")), ref)
    assert_same_archive(tw.load_npz(str(tmp_path / "by_jax.npz")), ours)
    assert not list(tmp_path.glob("*.tmp.npz"))


def test_to_jax_params_inverts_from_jax_params():
    net = tdet.RetinaFaceNet()
    sd = tw.random_state_dict(net, seed=4)
    params = tw.to_jax_params(sd)
    assert list(params) == list(sd)
    assert params["body.conv1.weight"].shape == (7, 7, 3, 64)  # HWIO
    assert all(v.dtype == np.float32 for v in params.values())
    back = tw.from_jax_params(params, net)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_npz_and_weights_dir_shadowing_order(tmp_path, no_cache):
    """An explicit weights_dir's checkpoint wins over a cached archive, and
    within one directory the archive wins over the checkpoint."""
    rng = np.random.default_rng(8)
    small = lambda: te.RRDBNetwork(2)  # noqa: E731
    first, second = (reference_checkpoint(small(), rng) for _ in range(2))
    wdir = tmp_path / "w"
    wdir.mkdir()
    torch.save(first, wdir / "bsrgan_x4_enhancer.pth")
    tw.save_npz(tw.to_jax_params(second), str(no_cache / "rrdb.npz"))
    got = tw.find_weights("rrdb", str(wdir), small())
    assert torch.equal(got["conv_first.weight"], first["conv_first.weight"])
    torch.save(second, wdir / "bsrgan_x4_enhancer.pth")  # the archive beside it wins now
    got = tw.find_weights("rrdb", str(wdir), small())
    assert torch.equal(got["conv_first.weight"], first["conv_first.weight"])
    got = tw.find_weights("rrdb", None, small())
    assert torch.equal(got["conv_first.weight"], second["conv_first.weight"])


# ---------------------------------------------------------------------------
# Fetching (JAX tests/test_convert.py:92-177, against the port)
# ---------------------------------------------------------------------------


class _Tiny(nn.Module):
    """The keys of the tiny served checkpoint."""

    def __init__(self):
        super().__init__()
        self.conv_first = nn.Conv2d(3, 64, 3)


def _small_pth(path):
    """Tiny state dict under the reference's released filename."""
    sd = {
        "conv_first.weight": torch.zeros(64, 3, 3, 3),
        "conv_first.bias": torch.arange(64, dtype=torch.float32),
    }
    torch.save(sd, str(path))


@pytest.fixture
def served(tmp_path, no_cache, monkeypatch):
    """A ``file://`` root serving the tiny checkpoint; the fetch on."""
    monkeypatch.setenv("FCPT_NO_DOWNLOAD", "0")
    srv = tmp_path / "srv"
    srv.mkdir()
    _small_pth(srv / "bsrgan_x4_enhancer.pth")
    monkeypatch.setenv("FCPT_WEIGHTS_URL", srv.as_uri() + "/")
    return srv


def test_download_pth_file_url(served, no_cache):
    got = tw.download_pth("rrdb")
    assert got == str(no_cache / "bsrgan_x4_enhancer.pth")
    assert (no_cache / "bsrgan_x4_enhancer.pth").read_bytes() == (
        served / "bsrgan_x4_enhancer.pth").read_bytes()
    # The second call hits the local file, not the "network".
    (served / "bsrgan_x4_enhancer.pth").unlink()
    assert tw.download_pth("rrdb") == got
    assert tw.download_pth("no-such-model") is None


def test_find_weights_auto_downloads_and_converts(tmp_path, served, no_cache, monkeypatch):
    net = _Tiny()
    sd = tw.find_weights("rrdb", None, net)
    assert sd["conv_first.weight"].shape == (64, 3, 3, 3)  # OIHW for the network
    np.testing.assert_array_equal(sd["conv_first.bias"].numpy(), np.arange(64))
    net.load_state_dict(sd, strict=True)
    # The cached archive is the JAX package's for the same served file.
    monkeypatch.setenv("FCPT_CACHE_DIR", str(tmp_path / "jax_cache"))
    ref = jw.find_weights("rrdb", None)
    assert_same_archive(tw.load_npz(str(no_cache / "rrdb.npz")), ref)
    assert ref["conv_first.weight"].shape == (3, 3, 3, 64)  # HWIO on disk
    # Later lookups need no .pth at all.
    monkeypatch.setenv("FCPT_CACHE_DIR", str(no_cache))
    (no_cache / "bsrgan_x4_enhancer.pth").unlink()
    again = tw.find_weights("rrdb", None, _Tiny())
    assert torch.equal(again["conv_first.bias"], sd["conv_first.bias"])


def test_find_weights_without_auto_download_finds_nothing(served, no_cache):
    assert tw.find_weights("rrdb", None, _Tiny(), auto_download=False) is None
    assert not no_cache.exists()


def test_download_disabled_by_env(served, no_cache, monkeypatch):
    monkeypatch.setenv("FCPT_NO_DOWNLOAD", "1")
    assert tw.download_pth("rrdb") is None
    assert tw.find_weights("rrdb", None, _Tiny()) is None
    assert not no_cache.exists()


def test_download_failure_is_soft(tmp_path, no_cache, monkeypatch):
    monkeypatch.setenv("FCPT_NO_DOWNLOAD", "0")
    monkeypatch.setenv("FCPT_WEIGHTS_URL", (tmp_path / "nope").as_uri() + "/")
    with pytest.warns(UserWarning, match="Could not download"):
        assert tw.download_pth("rrdb") is None
    assert list(no_cache.glob("*.part")) == []  # no partial file left behind
    net = te.RRDBNetwork(2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert not tw.load_or_init("rrdb", net, None)
    assert any("Falling back to random" in str(x.message) for x in w)
    ref = tw.random_state_dict(te.RRDBNetwork(2))
    assert all(torch.equal(v, ref[k]) for k, v in net.state_dict().items())


def test_failed_root_is_not_tried_again(tmp_path, no_cache, monkeypatch):
    monkeypatch.setenv("FCPT_NO_DOWNLOAD", "0")
    root = tmp_path / "late"
    monkeypatch.setenv("FCPT_WEIGHTS_URL", root.as_uri())  # no trailing slash
    with pytest.warns(UserWarning, match="Could not download"):
        assert tw.download_pth("rrdb") is None
    root.mkdir()
    _small_pth(root / "bsrgan_x4_enhancer.pth")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # skipped: no second attempt, no warning
        assert tw.download_pth("rrdb") is None
    other = tmp_path / "other"
    other.mkdir()
    _small_pth(other / "bsrgan_x4_enhancer.pth")
    assert tw.download_pth("rrdb", url_root=other.as_uri()) == str(
        no_cache / "bsrgan_x4_enhancer.pth")


def test_weights_dir_pth_is_cached_next_to_it(tmp_path, no_cache):
    wdir = tmp_path / "w"
    wdir.mkdir()
    _small_pth(wdir / "bsrgan_x4_enhancer.pth")
    assert tw.find_weights("rrdb", str(wdir), _Tiny()) is not None
    assert (wdir / "rrdb.npz").is_file()
    assert not no_cache.exists()


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _bad(converted: dict) -> dict:
    """One missing key, one unexpected, one wrong shape (JAX
    tests/test_convert.py:55-66)."""
    bad = dict(converted)
    first = next(iter(bad))
    del bad[first]
    bad["bogus.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    last = next(k for k in reversed(bad) if k.endswith(".bias"))
    bad[last] = np.zeros((7,), np.float32)
    return bad


@pytest.mark.parametrize("model", ["retinaface", "rrdb", "bisenet"])
def test_verify_structure_lists_equal_jax(model):
    rng = np.random.default_rng(2)
    net = {"retinaface": tdet.RetinaFaceNet, "rrdb": lambda: te.RRDBNetwork(2),
           "bisenet": tp.BiSeNetNet}[model]()
    converted = tw.to_jax_params(tw.convert_state_dict(reference_checkpoint(net, rng)))
    for case in (converted, _bad(converted)):
        got = tconvert.verify_structure(case, model)
        assert got == jconvert.verify_structure(case, model)
    if model == "rrdb":  # 2 blocks against the 23 of the network
        assert "missing from checkpoint: RRDB_trunk.22.RDB3.conv5.weight (3, 3, 192, 64)" in got
        assert not any("RRDB_trunk.1." in p for p in got)
    else:
        assert tconvert.verify_structure(converted, model) == []
        assert len(got) == 3


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_matches_jax(tmp_path, no_cache, capsys):
    sd = bisenet_checkpoint(aux=False)
    pth = tmp_path / "bise_parser.pth"
    torch.save(sd, pth)
    out = tmp_path / "out" / "parser"  # ".npz" appended
    results = {}
    for name, main in (("jax", jconvert.main), ("port", tconvert.main)):
        rc, text = _run(main, ["--pth", str(pth), "--out", str(out), "--verify"], capsys)
        results[name] = (rc, text, jw.load_npz(str(out) + ".npz"))
    assert results["port"][:2] == results["jax"][:2]
    assert results["port"][0] == 0
    assert "verify OK" in results["port"][1] and f"wrote {out}.npz" in results["port"][1]
    assert_same_archive(results["port"][2], results["jax"][2])

    # The model inferred from the filename; the cache dir by default.
    rc, text = _run(tconvert.main, ["--pth", str(pth)], capsys)
    assert rc == 0 and text.endswith(f"wrote {no_cache / 'bisenet.npz'}\n")
    assert_same_archive(tw.load_npz(str(no_cache / "bisenet.npz")), results["jax"][2])


def test_cli_verify_failure_matches_jax(tmp_path, capsys):
    sd = bisenet_checkpoint(aux=True)  # the auxiliary head is unexpected
    del sd["ffm.conv1.weight"]
    sd["conv_out.conv_out.weight"] = torch.zeros(19, 256, 3, 3)
    pth = tmp_path / "bise_parser.pth"
    torch.save(sd, pth)
    texts = []
    for main in (jconvert.main, tconvert.main):
        out = tmp_path / f"{len(texts)}.npz"
        rc, text = _run(main, ["--pth", str(pth), "--out", str(out), "--verify"], capsys)
        assert rc == 1 and not out.exists()
        texts.append(text)
    assert texts[1] == texts[0]
    assert "VERIFY FAILED (4 problems):" in texts[1]
    for line in ("missing from checkpoint: ffm.conv1.weight (1, 1, 256, 64)",
                 "unexpected in checkpoint: conv_out16.conv_out.weight (1, 1, 64, 19)",
                 "shape mismatch: conv_out.conv_out.weight checkpoint (3, 3, 256, 19) "
                 "vs model (1, 1, 256, 19)"):
        assert line in texts[1]


def test_cli_needs_a_model_for_other_filenames(tmp_path, capsys):
    torch.save({"x.bias": torch.zeros(2)}, tmp_path / "mine.pth")
    with pytest.raises(SystemExit) as exc:
        tconvert.main(["--pth", str(tmp_path / "mine.pth")])
    assert exc.value.code == 2
    assert "--model is required" in capsys.readouterr().err
