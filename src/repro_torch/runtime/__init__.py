"""Runtime services of the port: fault tolerance (retries, the training
supervisor, elastic rescale, worker-failure redispatch) and the
multi-process fleet workers."""
