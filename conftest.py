"""Pytest setup for the whole repository: build the native library once.

``pcmseg_tpu/data/native.py`` builds ``native/libpcmseg_native.so`` with
``make -C native`` when it is missing, and tests decide while they are
collected whether it loads. Under pytest-xdist every worker would run that
``make`` at once, and a worker could load a library another worker is
still writing, then skip the tests that need it. Here the controlling
process (or the only one, without xdist) runs ``make -C native`` before
any worker starts; each worker's own ``make`` then finds the library up
to date and writes nothing. Without a compiler the build fails quietly and
the tests behave as they do without this file.

Imports neither JAX nor the JAX package: the controller stays light.
"""

import os
import subprocess

NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")


def pytest_configure(config):
    if hasattr(config, "workerinput") or not os.path.exists(os.path.join(NATIVE, "Makefile")):
        return
    try:
        subprocess.run(["make", "-C", NATIVE], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass
