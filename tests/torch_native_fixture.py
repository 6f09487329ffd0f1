"""One fixture for the port's test files that hold the port's image reads
against tpudl's native decoder.

tpudl's ``native.build`` writes ``tpudl/native/libtpudl_decode.so`` in
place (``g++ ... -o <lib>``), so under pytest workers one process can be
loading the library while another is still writing it; tpudl then falls
back to PIL and its pixels differ from the port's. The fixture points
tpudl's decoder at a library of this worker's own (built by tpudl's own
``build``, with its compiler command and flags) for the length of a test
module, and puts tpudl's module state back afterwards. tpudl's code and
its shared library stay as they are.

Use it in a test module with::

    from torch_native_fixture import private_tpudl_decoder  # noqa: F401

    pytestmark = pytest.mark.usefixtures("private_tpudl_decoder")
"""

import pytest

from tpudl import native as jnative


@pytest.fixture(scope="module")
def private_tpudl_decoder(tmp_path_factory):
    """The path of this worker's private build of tpudl's decoder, which
    tpudl's ``native`` module loads while the fixture is active. The
    library is built once a worker (the worker's base temporary
    directory) and reused by its later modules."""
    d = tmp_path_factory.getbasetemp() / "tpudl_native"
    d.mkdir(exist_ok=True)
    lib = d / "libtpudl_decode.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", str(lib))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_build_failed", False)
        yield lib
