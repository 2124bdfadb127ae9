"""The port's C ABI: the embedding shim ``capi.cc`` over ``capi_bridge.py``,
its build (``build.py``) and a pure-C consumer of the header
(``abi_consumer.c``)."""
