"""``parallel/tp.py::ToDevices``: a tensor copied to several cards gets its
copies' gradients summed in shard order as one f32 left fold, whatever order
autograd delivers them in.  On the CPU every copy lies on the one device, so
the fold is held against the explicit sum with values where the order
changes the f32 result."""

import pytest
import torch

from ucod_dpl_tpu_torch.parallel.tp import ToDevices, place_grid, place_shard, to_devices

CPU = torch.device("cpu")


def _fold(grads, dtype, acc_dtype=torch.float32):
    acc = grads[0].to(acc_dtype)
    for g in grads[1:]:
        acc = acc + g.to(acc_dtype)
    return acc.to(dtype)


# f32: (1e8 + 1) - 1e8 is 0 in f32, any order that adds 1 last gives 1;
# bf16: 256 + 1 rounds to 256 in bf16, but the f32 fold keeps 257 until -256
@pytest.mark.parametrize("dtype,terms,want", [
    (torch.float32, (1e8, 1.0, -1e8), 0.0),
    (torch.float32, (1.0, 1e8, -1e8), 0.0),
    (torch.float32, (-1e8, 1e8, 1.0), 1.0),
    (torch.bfloat16, (256.0, 1.0, -256.0), 1.0),
    (torch.bfloat16, (1.0, 256.0, -256.0, 1.0), 2.0),
])
def test_to_devices_backward_is_the_shard_order_f32_fold(dtype, terms, want):
    x = torch.tensor([0.5, -2.0, 3.0], dtype=dtype, requires_grad=True)
    outs = ToDevices.apply(x, (CPU,) * len(terms))
    assert len(outs) == len(terms)
    assert all(o.dtype == dtype and torch.equal(o, x.detach()) for o in outs)
    grads = [torch.full((3,), t, dtype=dtype) for t in terms]
    torch.autograd.backward(outs, grads)
    assert x.grad.dtype == dtype
    assert torch.equal(x.grad, _fold(grads, dtype))
    assert torch.equal(x.grad, torch.full((3,), want, dtype=dtype))
    # the same terms added in another order, or in the gradient's own dtype
    # as autograd adds them, give another sum: the test can fail
    others = [_fold(grads[k:] + grads[:k], dtype, acc) for k in range(len(grads)) for acc in (torch.float32, dtype)]
    assert any(not torch.equal(o, x.grad) for o in others)


def test_to_devices_skips_copies_without_a_gradient():
    """A copy that reaches no loss adds nothing to the fold."""
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    a, b, c = ToDevices.apply(x, (CPU, CPU, CPU))
    (a * 3.0 + c * 5.0).sum().backward()
    assert torch.equal(x.grad, torch.tensor([8.0, 8.0]))


def test_to_devices_on_one_device_is_the_tensor_itself():
    """Over one distinct device ``to_devices`` is ``x.to(device)``: one-card
    paths keep their bits."""
    x = torch.randn(4, requires_grad=True)
    assert all(t is x for t in to_devices(x, [CPU, torch.device("cpu")]))


def test_place_grid_matches_place_shard():
    """Placing several targets at once gives each target what placing it
    alone gives, and a gradient through two shards' copies reaches the
    master."""
    gen = torch.Generator().manual_seed(0)
    layer = {name: {"w": torch.randn(8, 4, generator=gen), "b": torch.randn(8, generator=gen)}
             for name in ("q", "k", "v", "fc1")}
    layer.update({name: {"w": torch.randn(4, 8, generator=gen), "b": torch.randn(4, generator=gen)}
                  for name in ("out", "fc2")})
    layer["norm1"] = {"w": torch.randn(4, generator=gen, requires_grad=True), "b": torch.randn(4, generator=gen)}
    params = {"pos_embed": torch.randn(1, 5, 4, generator=gen), "layers": [layer]}
    both = place_grid(params, [[(0, CPU), (1, CPU)]], 2)[0]
    for m in range(2):
        one = place_shard(params, m, 2, CPU)
        flat = lambda t: [x for v in t["layers"][0].values() for x in v.values()] + [t["pos_embed"]]
        assert all(torch.equal(a, b) for a, b in zip(flat(both[m]), flat(one)))
    (both[0]["layers"][0]["norm1"]["w"].sum() * 2 + both[1]["layers"][0]["norm1"]["w"].sum()).backward()
    assert torch.equal(layer["norm1"]["w"].grad, torch.full((4,), 3.0))
