"""The port's interactive architecture diagram renders the JAX package's
bytes: ``render_html(model_diagram(hp))`` and ``save_html`` for both model
families, with each ablation flag off, and 4 and 8 metadata features."""

import dataclasses

import pytest

from maunet_tpu.analysis import diagram_html as jax_diagram

from maunet_tpu_torch.analysis import diagram_html

FLAGS = [(True, True), (False, False), (True, False), (False, True)]


@pytest.mark.parametrize("meta_features", [4, 8])
@pytest.mark.parametrize("temporal,metadata", FLAGS)
@pytest.mark.parametrize("model_type", ["unet", "unet++"])
def test_html_is_byte_equal_to_jax(model_type, temporal, metadata, meta_features, tmp_path):
    hp = {"model_type": model_type, "base_filters": 32 if model_type == "unet++" else 64,
          "temporal_embeddings": temporal, "metadata_embeddings": metadata,
          "temporal_dim": 64, "meta_dim": 48, "lstm_hidden": 96,
          "metadata_features": meta_features, "temporal_length": 828}
    got, want = diagram_html.model_diagram(hp), jax_diagram.model_diagram(hp)
    assert [dataclasses.astuple(n) for n in got.nodes] == \
        [dataclasses.astuple(n) for n in want.nodes]
    assert [dataclasses.astuple(e) for e in got.edges] == \
        [dataclasses.astuple(e) for e in want.edges]
    html = diagram_html.render_html(got, height=480)
    assert html == jax_diagram.render_html(want, height=480)
    assert "mau-node" in html and "conv0_0" in html
    port_file = diagram_html.save_html(hp, str(tmp_path / "port.html"))
    jax_file = jax_diagram.save_html(hp, str(tmp_path / "jax.html"))
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()


def test_the_reference_key_names_and_unknown_edges():
    """The reference's checkpoint keys (``lstm_dim``, ``meta_features``,
    ``seq_len``, ``unetpp``) give the same diagram, and an edge to an
    unknown node is refused as in the JAX package."""
    hp = {"model_type": "unetpp", "base_filters": 8, "lstm_dim": 50,
          "meta_features": 5, "seq_len": 64}
    assert diagram_html.render_html(diagram_html.model_diagram(hp)) == \
        jax_diagram.render_html(jax_diagram.model_diagram(hp))
    d = diagram_html.Diagram("t")
    d.node("a", 0, 0, "A")
    d.edge("a", "b")
    with pytest.raises(ValueError, match="unknown node"):
        diagram_html.render_html(d)
