"""The program side of the task-model kinds: ``<kind>.py`` holds
``build(model, device)``, the port's module for a configuration's
``model`` entry; ``spec.model_builder`` finds it by ``model.kind``. With
``program.py`` these are the only modules of the benchmark that import
the port."""
