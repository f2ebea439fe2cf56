"""P2P networking: msgpack-over-UDP packets, peer service, tracker.

Rebuild of the reference's hand-rolled distributed layer
(the reference's src/net/{udp_packets,udp_service}.rs and
src/bin/dawntrack.rs): tracker-coordinated open membership, best-effort
query fan-out with a fixed collection deadline, i24-quantized embedding
wire format, compressed insert replication. Port of dawnsearch_tpu/net/:
the same packets, byte for byte, in both wire formats, so port nodes and
reference nodes share one swarm.
"""
