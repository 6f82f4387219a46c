"""PyTorch port: its own configuration and constants equal the JAX package's,
field by field, and its modules do not need the JAX package's."""
import dataclasses

import pytest

from long_vita_tpu import config as jax_config
from long_vita_tpu import constants as jax_constants
from long_vita_tpu_torch import config as port_config
from long_vita_tpu_torch import constants as port_constants


@pytest.mark.parametrize("name", ["long_vita_14b", "tiny_test_config"])
def test_configs_agree_field_by_field(name):
    want = getattr(jax_config, name)()
    got = getattr(port_config, name)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__module__ == "long_vita_tpu_torch.config"
    for attr in ("head_dim", "num_query_groups"):
        assert getattr(got.text, attr) == getattr(want.text, attr)
    for attr in ("grid", "num_patches", "seq_len", "head_dim"):
        assert getattr(got.vision, attr) == getattr(want.vision, attr)


def test_tiny_config_arguments_and_hf_loader_agree(tmp_path):
    got = port_config.tiny_test_config(vocab_size=256, num_experts=4)
    want = jax_config.tiny_test_config(vocab_size=256, num_experts=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    hf = {"vocab_size": 1000, "hidden_size": 128, "num_hidden_layers": 3, "unknown": 1,
          "visual": {"hidden_size": 64, "patch_size": 16, "other": 2}}
    path = tmp_path / "config.json"
    path.write_text(__import__("json").dumps(hf))
    for loaded in (port_config.LongVITAConfig.from_json(str(path)),
                   port_config.LongVITAConfig.from_hf_config(hf)):
        assert dataclasses.asdict(loaded) == dataclasses.asdict(
            jax_config.LongVITAConfig.from_hf_config(hf)
        )
    assert port_config.LongVITAConfig.from_hf_config({"hidden_size": 32}).vision is None


def test_ignore_index_agrees():
    assert port_constants.IGNORE_INDEX == jax_constants.IGNORE_INDEX == -100
    from long_vita_tpu_torch.training import loss

    assert loss.IGNORE_INDEX is port_constants.IGNORE_INDEX
