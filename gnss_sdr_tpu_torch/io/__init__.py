from .native import NativeFileSource, convert, native_available  # noqa: F401
from .devices import MockDevice, SdrDevice, SdrInfo, SoapyDevice, open_device  # noqa: F401
