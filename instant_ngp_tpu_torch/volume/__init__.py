"""Volume mode: a neural radiance cache of a scattering medium
(instant-ngp's src/testbed_volume.cu)."""

from .testbed_volume import VolumeTestbed, load_nanovdb_header  # noqa: F401
