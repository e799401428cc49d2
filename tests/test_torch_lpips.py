"""The port's LPIPS (``cdfo_tpu_torch/metrics/lpips.py``), its head trainer
(``metrics/lpips_train.py``) and the params carried across
(``compat/lpips_params.py``) against ``cdfo_tpu/metrics/lpips.py`` and
``lpips_train.py``, in float32 on the CPU, within 1e-4 of the reference's
largest magnitude (the JAX suite's tolerance):

- each trunk's taps (vgg, alex, squeeze) and the averaged distance, on
  ``cdfo_tpu``'s seeded params carried across;
- ``spatial``: ``cdfo_tpu``'s raises for every trunk (it adds maps of
  different sizes); the port's per-tap maps equal those computed from
  ``cdfo_tpu``'s taps and heads, and its spatial map is their bilinear
  upsampling to the input size, summed (the reference's ``spatial``);
- SqueezeNet's pools floor as ``cdfo_tpu``'s do, where torchvision's
  ``ceil_mode=True`` rounds up (66x66: 15 against 16 after the first);
- ``load_torch_weights`` on torchvision-format backbones and richzhang
  heads built here: equal to ``cdfo_tpu``'s for vgg and alex; for squeeze
  the port loads every convolution, ``cdfo_tpu`` only ``features.0`` (its
  fire modules keep their init);
- three ``LPIPSHeadTrainer`` steps from the same heads and ranking net:
  losses and heads within 1e-4, heads >= 0 (torch's Adam and optax's put
  eps outside the square root alike, which the steps hold);
- ``score_2afc``, ``voc_ap`` and ``score_jnd`` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cdfo_tpu.metrics import lpips as jl
from cdfo_tpu.metrics import lpips_train as jlt
from cdfo_tpu_torch.compat import dist2logit_from_flax, lpips_from_flax
from cdfo_tpu_torch.metrics import lpips as tl
from cdfo_tpu_torch.metrics import lpips_train as tlt

TRUNK = {"vgg": jl.VGG16Features, "alex": jl.AlexNetFeatures,
         "squeeze": jl.SqueezeNetFeatures}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(port, ref, what="", rel=1e-4):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def images(seed, b=2, size=32):
    r = np.random.RandomState(seed)
    x = r.rand(b, size, size, 3).astype(np.float32) * 2 - 1
    return x, np.clip(x + r.randn(*x.shape).astype(np.float32) * 0.3, -1, 1)


@pytest.fixture(scope="module")
def jax_params():
    """net -> ``cdfo_tpu``'s LPIPS params (seeded, heads made >= 0 as
    trained heads are), each initialised once."""
    cache = {}

    def get(net):
        if net not in cache:
            x = np.zeros((1, 32, 32, 3), np.float32)
            params = jax.tree.map(np.asarray, jax.jit(jl.LPIPS(net=net).init)(
                jax.random.PRNGKey(1), x, x))
            for i in range(len(tl.TRUNKS[net][1])):
                lin = params["params"][f"lin{i}"]
                lin["kernel"] = np.abs(lin["kernel"])
            cache[net] = params
        return cache[net]

    return get


@pytest.fixture(scope="module", params=["vgg", "alex", "squeeze"])
def carried(request, jax_params):
    """(net, cdfo_tpu's params, the port's LPIPS on them)."""
    net = request.param
    params = jax_params(net)
    tm = tl.LPIPS(net, device="cpu")
    missing = tm.load_state_dict(lpips_from_flax(params, net), strict=False)
    assert not missing.unexpected_keys
    assert set(missing.missing_keys) == {"shift", "scale"}
    return net, params, tm


@jax.jit
def _scaled(x):
    return (x - jl._SHIFT) / jl._SCALE


def jax_taps(net, params, x):
    return jax.jit(TRUNK[net]().apply)({"params": params["params"]["net"]},
                                       _scaled(x))


def test_trunk_taps_match(carried):
    net, params, tm = carried
    x, _ = images(2)
    want = jax_taps(net, params, x)
    got = tm.net((nchw(x) - tm.shift) / tm.scale)
    assert len(got) == len(want) == tm.heads
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, np.asarray(w).transpose(0, 3, 1, 2), f"{net} tap {i}")


@pytest.mark.parametrize("normalize", [False, True])
def test_distance_matches(carried, normalize):
    net, params, tm = carried
    x, y = images(3)
    if normalize:
        x, y = (x + 1) / 2, (y + 1) / 2
    want = jax.jit(jl.LPIPS(net=net, normalize_input=normalize).apply)(
        params, x, y)
    tm.normalize_input = normalize
    try:
        got = tm(nchw(x), nchw(y))
    finally:
        tm.normalize_input = False
    assert_close(got, want, f"{net} distance")
    assert (np.asarray(want) > 0).all()


def test_spatial_raises_in_cdfo_tpu_and_upsamples_in_the_port(carried):
    net, params, tm = carried
    x, y = images(4)
    with pytest.raises(TypeError, match="broadcast"):
        jax.jit(jl.LPIPS(net=net, spatial=True).apply)(params, x, y)
    fx, fy = jax_taps(net, params, x), jax_taps(net, params, y)
    maps = []
    for i, (a, b) in enumerate(zip(fx, fy)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.square(a / (np.sqrt((a * a).sum(-1, keepdims=True)) + 1e-10)
                      - b / (np.sqrt((b * b).sum(-1, keepdims=True)) + 1e-10))
        w = params["params"][f"lin{i}"]["kernel"][0, 0, :, 0]
        maps.append((d @ w)[:, None].astype(np.float32))
    got = tm.layer_distances(nchw(x), nchw(y))
    for i, (g, m) in enumerate(zip(got, maps)):
        assert_close(g, m, f"{net} map {i}")
    want = sum(F.interpolate(torch.from_numpy(m), size=x.shape[1:3],
                             mode="bilinear", align_corners=False)
               for m in maps)
    tm.spatial = True
    try:
        spatial = tm(nchw(x), nchw(y))
    finally:
        tm.spatial = False
    assert_close(spatial, want.numpy(), f"{net} spatial")


def test_squeeze_pools_floor_as_cdfo_tpu():
    """66x66: the first pool sees 32x32, floor gives 15, ceil 16."""
    x = np.random.RandomState(5).rand(1, 66, 66, 3).astype(np.float32)
    jm = jl.SqueezeNetFeatures()
    taps = jax.eval_shape(
        lambda x: jm.apply(jm.init(jax.random.PRNGKey(0), x), x), x)
    got = tl.SqueezeNetFeatures()(nchw(x))
    assert [t.shape[2:] for t in got] == [t.shape[1:3] for t in taps]
    assert got[1].shape[2] == 15
    ceil = torch.nn.MaxPool2d(3, 2, ceil_mode=True)(torch.zeros(1, 1, 32, 32))
    assert ceil.shape[2] == 16


def torchvision_state(net, r):
    """A torchvision-format ``state_dict`` of ``net``'s features, seeded
    values, and a classifier that loading skips (vgg's and alex's linear,
    squeezenet's a 1x1 conv), cut to 10 classes."""
    sd = {}
    model = tl.TRUNKS[net][0]()
    for k, v in model.features.state_dict().items():
        sd[f"features.{k}"] = torch.from_numpy(
            r.randn(*v.shape).astype(np.float32) * 0.1)
    if net == "squeeze":
        sd["classifier.1.weight"] = torch.zeros(10, 512, 1, 1)
    else:
        sd["classifier.6.weight"] = torch.zeros(10, 4096)
    sd[next(k for k in sd if k.startswith("classifier"))[:-6] + "bias"] = \
        torch.zeros(10)
    return sd


@pytest.mark.parametrize("net", ["vgg", "alex", "squeeze"])
def test_load_torch_weights(net, tmp_path, jax_params):
    r = np.random.RandomState(6)
    backbone = torchvision_state(net, r)
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(
        r.rand(1, c, 1, 1).astype(np.float32))
        for i, c in enumerate(tl.TRUNKS[net][1])}
    torch.save(backbone, tmp_path / "backbone.pth")
    torch.save(heads, tmp_path / "heads.pth")
    init = jax_params(net)
    jloaded = lpips_from_flax(jax.tree.map(np.asarray, jl.load_torch_weights(
        init, str(tmp_path / "backbone.pth"), str(tmp_path / "heads.pth"),
        net=net)), net)
    untouched = lpips_from_flax(jax.tree.map(np.asarray, init), net)
    tm = tl.load_torch_weights(tl.LPIPS(net, device="cpu"),
                               str(tmp_path / "backbone.pth"),
                               str(tmp_path / "heads.pth"))
    sd = tm.state_dict()
    for k, v in backbone.items():
        if k.startswith("features."):
            assert torch.equal(sd[f"net.{k}"], v), k
    for k, v in heads.items():
        assert torch.equal(sd[k], v), k
    for k, v in jloaded.items():
        if net != "squeeze" or not k.startswith("net.features.") \
                or k.startswith("net.features.0."):
            assert torch.equal(sd[k], v), k
        else:
            # cdfo_tpu stops at its first missing conv name: the fire
            # modules keep their init
            assert torch.equal(v, untouched[k]), k
            assert not torch.equal(sd[k], v), k


def test_head_trainer_three_steps_match(jax_params):
    r = np.random.RandomState(8)
    ref, p0, p1 = (r.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1
                   for _ in range(3))
    judge = r.uniform(-1, 1, 4).astype(np.float32)
    model = jl.LPIPS(net="alex")
    params = jax.tree.map(jnp.asarray, jax_params("alex"))
    jt = jlt.LPIPSHeadTrainer(model, params, lr=1e-3, seed=4)
    tm = tl.LPIPS("alex", device="cpu")
    tm.load_state_dict(lpips_from_flax(jax.tree.map(np.asarray, params),
                                       "alex"), strict=False)
    rank = tlt.Dist2LogitLayer(device="cpu")
    rank.load_state_dict(dist2logit_from_flax(
        jax.tree.map(np.asarray, jt.rank_params)))
    tt = tlt.LPIPSHeadTrainer(tm, lr=1e-3, rank=rank)
    for step in range(3):
        want = jt.train_step(ref, p0, p1, judge)
        got = tt.train_step(nchw(ref), nchw(p0), nchw(p1), judge)
        assert abs(got - want) <= 1e-4 * abs(want), (step, got, want)
    heads = lpips_from_flax(jax.tree.map(np.asarray, jt.current_params()),
                            "alex")
    sd = tm.state_dict()
    for i in range(tm.heads):
        k = f"lin{i}.model.1.weight"
        assert_close(sd[k], heads[k].numpy(), k)
        assert (sd[k] >= 0).all() and (sd[k] == 0).any(), k
    rank_want = dist2logit_from_flax(jax.tree.map(np.asarray,
                                                  jt.trainable["rank"]))
    for k, v in rank.state_dict().items():
        assert_close(v, rank_want[k].numpy(), k)
    assert not any(p.requires_grad for p in tm.net.parameters())


def test_scores_match():
    r = np.random.RandomState(9)
    d0, d1 = r.rand(50), r.rand(50)
    d1[:5] = d0[:5]
    judges = r.rand(50)
    a, ja = tlt.score_2afc(d0, d1, judges), jlt.score_2afc(d0, d1, judges)
    assert a[0] == ja[0]
    for k in ja[1]:
        np.testing.assert_array_equal(a[1][k], ja[1][k])
    ds, sames = r.rand(40), (r.rand(40) < 0.4).astype(np.float64)
    assert tlt.score_jnd(ds, sames)[0] == jlt.score_jnd(ds, sames)[0]
    rec, prec = np.sort(r.rand(20)), r.rand(20)
    assert tlt.voc_ap(rec, prec) == jlt.voc_ap(rec, prec)
