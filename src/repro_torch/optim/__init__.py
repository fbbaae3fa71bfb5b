"""Update compression for the federated client-to-cloud path."""
