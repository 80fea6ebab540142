"""The SPU (broker) of the port: the public server (`server.SpuServer`,
`public_service`: produce, fetch, stream fetch and offsets over TCP), the
leader replicas over the log storage (`replica`), the global context and
the consume path, where stored batches run through a GPU chain and come
back as wire batches (`smart_chain`), and the link to an SC
(`sc_dispatcher`: registration, replica and SmartModule pushes, offset
reports)."""
