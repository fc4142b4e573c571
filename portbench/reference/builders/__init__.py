"""One builder per model type: ``builders/<type>.py`` holds
``skeleton(config)``, the plain reference model of a configuration, built
under the meta device by ``reference/model.py::skeleton``."""
