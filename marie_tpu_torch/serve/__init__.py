"""The serving plane of the port, on the standard library: gRPC, HTTP and
WebSocket servers, discovery, tracing and monitoring."""
