"""Wire schemas of the port: the SmartModule invocations a consumer
sends with a stream fetch."""
