"""Wire protocol of seldon_tpu_torch.

`prediction_pb2` is generated from `prediction.proto` by `protoc
--python_out`; its serialized descriptor is byte for byte the JAX
package's (`seldon_tpu/proto/prediction_pb2.py`), so both packages may
be imported into one process: protobuf's default pool takes identical
bytes for the same file twice. The gRPC service layer is hand-written in
`prediction_grpc.py`.
"""

from seldon_tpu_torch.proto import prediction_pb2

__all__ = ["prediction_pb2"]
