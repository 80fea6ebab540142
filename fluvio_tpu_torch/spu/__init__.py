"""The SPU's consume path of the port: stored batches through a GPU chain
and back to wire batches (`smart_chain`)."""
