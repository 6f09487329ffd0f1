"""configs[2]'s model — Keras InceptionV3 (``weights=None``,
``include_top=False``, ``pooling="avg"``) with a ``Dense(2, softmax)``
head — through the port's Keras evaluator, held to tpudl's
``TFInputGraph`` at 75×75, batch 2, with BN statistics perturbed from a
seed: the forward within 1e-5 of max |y|, the gradients of every one of
its 378 variables (BN's moving statistics included) within 1e-4 of the
largest, and the trainable keys equal to tpudl's, in ``model.weights``
order. The checks are ``test_torch_keras_graph``'s."""

import pytest

keras = pytest.importorskip("keras")

from test_torch_keras_graph import (check_forward,  # noqa: E402
                                    check_gradients, perturbed_file)

from tpudl.ingest import TFInputGraph as JaxGraph  # noqa: E402
from tpudl_torch.ingest import TFInputGraph  # noqa: E402


@pytest.fixture(scope="module")
def inception(tmp_path_factory):
    return perturbed_file("inception", tmp_path_factory.mktemp("inception"))


def test_forward_matches_tpudl(inception):
    check_forward(inception, "inception")


def test_gradients_match_tpudl_in_every_param(inception):
    check_gradients(inception, "inception")


def test_trainable_keys_are_tpudls_in_file_order(inception):
    path = inception
    model = keras.saving.load_model(path, compile=False)
    tg = TFInputGraph.fromKerasTrainable(path)
    assert list(tg.params) == [w.path for w in model.weights]
    assert set(tg.params) == set(JaxGraph.fromKerasTrainable(path).params)
    assert tg.input_names == ["input_layer:0"]
    assert tg.output_names == ["head:0"]
    assert tg.trainable and not TFInputGraph.fromKeras(path).trainable
