"""frontend subpackage."""
