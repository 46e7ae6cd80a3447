"""SDF mode: neural signed-distance fitting and sphere tracing
(instant-ngp's src/testbed_sdf.cu)."""

from .testbed_sdf import SdfTestbed  # noqa: F401
