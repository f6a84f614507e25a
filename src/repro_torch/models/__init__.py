"""Model layers of the port.  So far the host-routed MoE expert FFN
(``moe``); the rest of the LM stack comes with its own slice."""
