"""The port's ResNet-18-d1 against the JAX package's flax module, on weights
carried across from init_resnet_params, and the weight converters."""

import numpy as np
import pytest
import torch

from fgvc_tpu_torch.models.resnet import init_random, resnet18_d1
from fgvc_tpu_torch.models.weights import (
    convert_reference_state_dict,
    load_reference_pth,
    load_weights,
    state_dict_from_flax,
)


@pytest.fixture(scope="module")
def flax_resnet():
    import jax

    from fgvc_tpu.models.resnet import init_resnet_params
    from fgvc_tpu.models.resnet import resnet18_d1 as flax_resnet18_d1

    model = flax_resnet18_d1()
    variables = init_resnet_params(model, jax.random.PRNGKey(0), (32, 32))
    # non-trivial BN statistics, so the running mean/var mapping is checked
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.uniform(0.1, 0.5, np.shape(x)).astype(np.float32),
        variables["batch_stats"],
    )
    return model, {"params": variables["params"], "batch_stats": stats}


def _port_model(variables):
    return load_weights(resnet18_d1(), state_dict_from_flax(variables)).eval()


def test_layer3_matches_flax(flax_resnet):
    import jax.numpy as jnp

    model, variables = flax_resnet
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = _port_model(variables)(torch.from_numpy(x).permute(0, 3, 1, 2))
    out = out.permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape == (2, 16, 16, 256)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_reference_pth_round_trip(flax_resnet, tmp_path):
    """flax -> export_resnet_state_dict (mmcv naming) -> .pth ->
    load_reference_pth gives the same weights as state_dict_from_flax."""
    from fgvc_tpu.models.torch_convert import export_resnet_state_dict

    _, variables = flax_resnet
    exported = export_resnet_state_dict(variables)
    path = tmp_path / "ckpt.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in exported.items()}},
               path)
    loaded = load_reference_pth(str(path))
    direct = state_dict_from_flax(variables)
    assert sorted(loaded) == sorted(direct)
    for k in direct:
        np.testing.assert_array_equal(loaded[k].numpy(), direct[k].numpy())
    load_weights(resnet18_d1(), loaded)


def test_torchvision_naming_and_leftovers():
    model = init_random(resnet18_d1(), seed=0)
    tv = {f"backbone.{k}": v for k, v in model.state_dict().items()}
    converted = convert_reference_state_dict(tv)
    fresh = load_weights(resnet18_d1(), converted)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(fresh.state_dict()[k], v)
    tv["backbone.layer1.0.conv3.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unconverted"):
        convert_reference_state_dict(tv)


def test_random_init_is_seeded():
    a = init_random(resnet18_d1(), seed=0).conv1.weight
    b = init_random(resnet18_d1(), seed=0).conv1.weight
    c = init_random(resnet18_d1(), seed=1).conv1.weight
    assert torch.equal(a, b) and not torch.equal(a, c)
