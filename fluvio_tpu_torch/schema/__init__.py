"""Wire schemas of the port: the SmartModule invocations a consumer sends
with a stream fetch (`smartmodule`), the SPU's public requests (`spu`),
the SC's admin API (`admin`) and the SC <-> SPU private API
(`controlplane`)."""
