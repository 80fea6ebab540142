"""C++ sources of the port's host-side native pieces, shipped inside the
package so an install can build them on demand: the glz link compressor
(`glz.cpp`, a byte-identical copy of the JAX package's, so both packages
emit the same token streams; `smartengine/gpu/glz.py` loads it), the
consume path's columnar record codec (`records.cpp`, loaded by
`records.py`) and the lz4-frame / snappy codecs (`codecs.cpp`, a
byte-identical copy of the JAX package's, loaded by
`protocol/native_codecs.py`). Each compiles with g++ at first use into
`_build/` next to the source, keyed by its hash."""
