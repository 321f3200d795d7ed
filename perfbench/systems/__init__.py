"""The system under test: one adapter per configuration and traffic kind
(``systems/<config>/<kind>.py``, each giving ``System``), calling the
program's public entry points (epgpy_torch) as a user does."""
