"""The JAX repository's ``tools/`` Pallas probes, ported: :data:`PROBES`
holds one :class:`~.base.Probe` per probe (46, from 34 ``pl.pallas_call``
sites), each on one of the four kernels ``tail_conv``, ``window_resample``,
``int8_contract`` and ``strided_map``. ``tools/reprobe.py`` of the port
runs them on the card; ``chip_smoke.py`` drives them as a phase."""

from mit_driverless_cv_traininginfra_tpu_torch.probes import crop, mosaic, tail_conv1
from mit_driverless_cv_traininginfra_tpu_torch.probes.base import (  # noqa: F401
    KERNEL,
    PLAIN,
    WRAPPERS,
    Probe,
)

PROBES = mosaic.PROBES + crop.PROBES + [tail_conv1.PROBE]
BY_NAME = {p.name: p for p in PROBES}
assert len(BY_NAME) == len(PROBES), "probe names must be unique"
