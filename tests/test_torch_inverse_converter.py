"""The port's inverse converter (`compat/torch_ckpt.port_to_torch_backbone`:
a port NCSN++ state_dict -> the reference's torch naming) against the JAX
package's `flax_to_torch_backbone` of the same weights, bit for bit, and
its round trip through `convert_backbone_state_dict`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_params

from storm_tpu.backbones.ncsnpp import AutoEncodeNCSNpp as JAENCSNpp
from storm_tpu.backbones.ncsnpp import NCSNpp as JNCSNpp
from storm_tpu.compat import torch_ckpt as jtc
from storm_tpu_torch.backbones.ncsnpp import AutoEncodeNCSNpp, NCSNpp
from storm_tpu_torch.compat import torch_ckpt as ptc
from storm_tpu_torch.convert import module_params_from_jax

NETS = {  # name: (JAX class, port class, kwargs, input shape)
    "ncsnpp": (JNCSNpp, NCSNpp, dict(input_channels=4, nf=16, ch_mult=(1, 2), image_size=64),
               (1, 2, 64, 32, 2)),
    "ncsnpp_fir_ddpm": (JNCSNpp, NCSNpp, dict(input_channels=4, nf=16, ch_mult=(1, 2),
                                              image_size=64, resblock_type="ddpm",
                                              progressive="residual",
                                              progressive_input="residual"),
                        (1, 2, 64, 32, 2)),
    "ae-ncsnpp": (JAENCSNpp, AutoEncodeNCSNpp, dict(nf=16, ch_mult=(1, 2), image_size=32,
                                                    n_filters=32), (2, 4000)),
}


def _carried(name):
    """(flax tree, the port's net carrying it)."""
    jcls, pcls, kw, shape = NETS[name]
    jnet = jcls.from_kwargs(**kw)
    args = (jnp.zeros(shape), jnp.ones(shape[:1]))  # ae-ncsnpp: a waveform in
    tree = random_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), *args)["params"], 3)
    net = pcls.from_kwargs(**kw)
    net.load_state_dict(module_params_from_jax(tree), strict=True)
    return tree, net


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("prefix", ["", "score_net."])
def test_export_equals_the_reference_inverse_and_round_trips(name, prefix):
    tree, net = _carried(name)
    sd = net.state_dict()
    got = ptc.port_to_torch_backbone(sd, prefix=prefix)
    want = jtc.flax_to_torch_backbone(tree, prefix=prefix)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == v.shape, k
        assert np.array_equal(got[k].numpy().view(np.int32),
                              np.ascontiguousarray(v, np.float32).view(np.int32)), k
    back = ptc.convert_backbone_state_dict(got, prefix=prefix)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    if "fir" in name or name == "ncsnpp":
        assert any(k.endswith("Conv2d_0.weight") for k in got) == ("fir" in name)


def test_export_refuses_another_backbone():
    with pytest.raises(KeyError, match="not an NCSN\\+\\+ parameter"):
        ptc.port_to_torch_backbone({"TCN.TCN_0.conv1d_w": torch.ones(3)})
