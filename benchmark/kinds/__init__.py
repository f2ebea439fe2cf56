"""Traffic generators, one module per `kind` of a traffic file."""
