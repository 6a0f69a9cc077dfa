"""Serving on the port: the in-pod inference server (server.py), the
counterpart of tf_operator_tpu/serve/server.py. The operator side (the
InferenceService controller, autoscaling, the router) is the JAX
package's and starts this server unchanged, by the template's command."""
