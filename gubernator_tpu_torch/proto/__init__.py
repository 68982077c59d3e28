"""Wire schema (reference proto/gubernator.proto, proto/peers.proto),
carried over from the JAX package with the same bytes.

`gubernator_pb2` / `peers_pb2` are protoc-generated from the .proto
files in this directory; `peers_columns_pb2` (the columnar peer hop,
peers_columns.proto) was generated without protoc from its
FileDescriptorProto; `etcd_kv_pb2` / `etcd_rpc_pb2` are the wire subset
of etcd's v3 API that etcd discovery speaks (etcd_pool.py).  Service and message names are wire-compatible
with the reference, so stock Gubernator gRPC clients interoperate.

Nothing is imported here: the generated modules need `protobuf`, which
a machine serving only HTTP may lack, so wire.py imports them inside
the pb codecs that use them.
"""

V1_SERVICE = "pb.gubernator.V1"
PEERS_V1_SERVICE = "pb.gubernator.PeersV1"
