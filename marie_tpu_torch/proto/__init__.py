"""The serving plane's protobuf wire form, written on the standard library
(the card's machine has no ``protobuf`` package): :mod:`.wire`, the codec's
primitives, and :mod:`.messages`, the schemas of ``marie.proto`` and
``docarray.proto`` as field tables."""
