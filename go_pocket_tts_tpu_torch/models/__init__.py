"""Model graph of the port: FlowLM (transformer + flow-matching head) and the
Mimi decoder, as nested dicts of tensors keyed like the reference package's
parameter trees."""
