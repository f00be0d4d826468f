"""A module-scoped fixture's value made once a test session. Under
pytest-xdist every worker that runs a test of the module would make it
again (the gloo worlds and the reference's compiles, each time): here the
first worker makes it and saves it under the session's temporary root,
which the workers share, and the others wait on its lock and load it.
Without xdist it is made in place."""
import os

import torch
from filelock import FileLock


def once(tmp_path_factory, name, make):
    """``make()``, or what another worker of this session's made."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return make()
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pt"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return torch.load(path, weights_only=False)
        value = make()
        torch.save(value, path)
        return value
